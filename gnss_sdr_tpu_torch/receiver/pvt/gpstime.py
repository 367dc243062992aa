"""GPS time <-> calendar conversions (host, no external deps); a copy of
gnss_sdr_tpu/receiver/pvt/gpstime.py.

Reference analog: RTKLIB time utilities (``rtklib_rtkcmn.cc`` gpst2time/
time2epoch)."""

from __future__ import annotations

import datetime

GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)
DEFAULT_LEAP_SECONDS = 18


def gps_to_datetime(week: int, tow_s: float,
                    leap_seconds: int = DEFAULT_LEAP_SECONDS) -> datetime.datetime:
    """GPS week/TOW -> UTC datetime."""
    t = GPS_EPOCH + datetime.timedelta(weeks=week, seconds=tow_s - leap_seconds)
    return t


def gps_to_gpsdatetime(week: int, tow_s: float) -> datetime.datetime:
    """GPS week/TOW -> datetime on the GPS timescale (no leap adjustment)."""
    return GPS_EPOCH + datetime.timedelta(weeks=week, seconds=tow_s)


def datetime_to_gps(t: datetime.datetime,
                    leap_seconds: int = DEFAULT_LEAP_SECONDS) -> tuple[int, float]:
    dt = (t - GPS_EPOCH).total_seconds() + leap_seconds
    week = int(dt // 604800)
    return week, dt - week * 604800.0


def gpsdatetime_to_gps(t: datetime.datetime) -> tuple[int, float]:
    """Datetime on the GPS timescale -> (week, tow); inverse of
    gps_to_gpsdatetime."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=datetime.timezone.utc)
    dt = (t - GPS_EPOCH).total_seconds()
    week = int(dt // 604800)
    return week, dt - week * 604800.0
