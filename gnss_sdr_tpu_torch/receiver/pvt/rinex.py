"""RINEX 3.02 observation + navigation file writers and readers.

Port of gnss_sdr_tpu/receiver/pvt/rinex.py (reference analog:
``Rinex_Printer``, ``src/algorithms/PVT/libs/rinex_printer.cc``): the same
text, byte for byte, for what this port's receiver produces — observables
(C/L/D/S) of any signal, GPS LNAV / CNAV, Galileo I/NAV / F/NAV and
BeiDou D1 / D2 ephemerides (one Kepler record layout per system; the Galileo
record's data-source word is the JAX package's, 513, for both), GLONASS
GNAV state-vector records (geph) and SBAS GEO records (MT9).
"""

from __future__ import annotations

import datetime
import pathlib

from gnss_sdr_tpu_torch.receiver.pvt.gpstime import gps_to_gpsdatetime

_SYS_PREFIX = {"G": "G", "E": "E", "R": "R", "C": "C"}
_OBS_CODE = {"1C": "1C", "1B": "1B", "2S": "2S", "L5": "5I",
             "5X": "5I", "1G": "1C", "2G": "2C", "B1": "2I", "B3": "6I"}
_SYS_OF_SIGNAL = {"1C": "G", "2S": "G", "L5": "G", "1B": "E", "5X": "E",
                  "1G": "R", "2G": "R", "B1": "C", "B3": "C"}


def _hline(content: str, label: str) -> str:
    return f"{content:<60.60s}{label:<20.20s}\n"


def _f1912(x: float) -> str:
    """RINEX nav float: 19 chars, D exponent."""
    s = f"{x: 19.12E}"
    return s.replace("E", "D")


class RinexObsWriter:
    """Streaming RINEX observation writer (3.02 default, 2.11 option —
    the reference emits both, PVT.rinex_version)."""

    def __init__(self, path, signals: list[str], approx_pos=(0.0, 0.0, 0.0),
                 marker: str = "GNSS_SDR_TPU", version: str = "3.02",
                 glo_slots: dict | None = None):
        self.path = pathlib.Path(path)
        self.signals = signals
        self.version = str(version)
        self._systems = sorted({_SYS_OF_SIGNAL[s] for s in signals})
        self._f = open(self.path, "w")
        self._wrote_header = False
        self._approx = approx_pos
        self._marker = marker
        # GLONASS orbital slot (PRN) -> frequency channel number k; 3.02
        # requires the SLOT/FRQ table when R observations are present
        # (reference: rinex_printer.cc GLONASS SLOT / FRQ # block)
        self._glo_slots = dict(glo_slots or {})

    def _header(self, week: int, tow: float) -> None:
        if self.version.startswith("2"):
            self._header_v2(week, tow)
            return
        f = self._f
        f.write(_hline("     3.02           OBSERVATION DATA    M: Mixed",
                       "RINEX VERSION / TYPE"))
        now = datetime.datetime.now(datetime.timezone.utc)
        f.write(_hline(f"gnss_sdr_tpu        CTTC-TPU            {now:%Y%m%d %H%M%S} UTC",
                       "PGM / RUN BY / DATE"))
        f.write(_hline(self._marker, "MARKER NAME"))
        f.write(_hline("unknown             unknown", "OBSERVER / AGENCY"))
        f.write(_hline("1                   GNSS-SDR-TPU        0.1",
                       "REC # / TYPE / VERS"))
        f.write(_hline("1                   NONE", "ANT # / TYPE"))
        x, y, z = self._approx
        f.write(_hline(f"{x:14.4f}{y:14.4f}{z:14.4f}", "APPROX POSITION XYZ"))
        f.write(_hline(f"{0.0:14.4f}{0.0:14.4f}{0.0:14.4f}",
                       "ANTENNA: DELTA H/E/N"))
        for sys in self._systems:
            codes = [_OBS_CODE[s] for s in self.signals
                     if _SYS_OF_SIGNAL[s] == sys]
            obs = "".join(f" C{c} L{c} D{c} S{c}" for c in codes)
            f.write(_hline(f"{sys}  {4 * len(codes):3d}{obs}",
                           "SYS / # / OBS TYPES"))
        t = gps_to_gpsdatetime(week, tow)
        f.write(_hline(
            f"  {t.year:4d}    {t.month:2d}    {t.day:2d}    {t.hour:2d}"
            f"    {t.minute:2d}   {t.second + t.microsecond / 1e6:10.7f}"
            f"     GPS", "TIME OF FIRST OBS"))
        if "R" in self._systems:
            # mandatory 3.02 GLONASS records: slot -> frequency number
            # (8 pairs per line, continuations blank-count) and the
            # code/phase bias record (zeros: biases not estimated)
            pairs = sorted(self._glo_slots.items())
            f.write(_hline(
                f"{len(pairs):3d}" + "".join(
                    f" R{p:02d} {k:2d}" for p, k in pairs[:8]),
                "GLONASS SLOT / FRQ #"))
            for i in range(8, len(pairs), 8):
                f.write(_hline("   " + "".join(
                    f" R{p:02d} {k:2d}" for p, k in pairs[i:i + 8]),
                    "GLONASS SLOT / FRQ #"))
            f.write(_hline(
                " C1C    0.000 C1P    0.000 C2C    0.000 C2P    0.000",
                "GLONASS COD/PHS/BIS"))
        f.write(_hline("", "END OF HEADER"))
        self._wrote_header = True

    def _header_v2(self, week: int, tow: float) -> None:
        f = self._f
        f.write(_hline("     2.11           OBSERVATION DATA    M (MIXED)",
                       "RINEX VERSION / TYPE"))
        now = datetime.datetime.now(datetime.timezone.utc)
        f.write(_hline(f"gnss_sdr_tpu        CTTC-TPU            {now:%Y%m%d %H%M%S} UTC",
                       "PGM / RUN BY / DATE"))
        f.write(_hline(self._marker, "MARKER NAME"))
        x, y, z = self._approx
        f.write(_hline(f"{x:14.4f}{y:14.4f}{z:14.4f}", "APPROX POSITION XYZ"))
        f.write(_hline(f"{4:6d}    C1    L1    D1    S1",
                       "# / TYPES OF OBSERV"))
        t = gps_to_gpsdatetime(week, tow)
        f.write(_hline(
            f"  {t.year:4d}    {t.month:2d}    {t.day:2d}    {t.hour:2d}"
            f"    {t.minute:2d}   {t.second + t.microsecond / 1e6:10.7f}"
            f"     GPS", "TIME OF FIRST OBS"))
        f.write(_hline("", "END OF HEADER"))
        self._wrote_header = True

    def write_epoch(self, week: int, tow: float, observables: list) -> None:
        """observables: list of ChannelObservable."""
        if not observables:
            return
        if not self._wrote_header:
            self._header(week, tow)
        t = gps_to_gpsdatetime(week, tow)
        sec = t.second + t.microsecond / 1e6
        if self.version.startswith("2"):
            ids = [f"{_SYS_OF_SIGNAL[o.signal]}{o.prn:02d}"
                   for o in observables]
            self._f.write(
                f" {t.year % 100:02d} {t.month:2d} {t.day:2d} {t.hour:2d} "
                f"{t.minute:2d}{sec:11.7f}  0{len(observables):3d}"
                f"{''.join(ids[:12])}\n")
            for k in range(12, len(ids), 12):   # v2 continuation lines
                self._f.write(" " * 32 + "".join(ids[k: k + 12]) + "\n")
            for o in observables:
                self._f.write(
                    f"{o.pseudorange_m:14.3f}  "
                    f"{o.carrier_phase_cycles:14.3f}  "
                    f"{o.doppler_hz:14.3f}  "
                    f"{o.cn0_dbhz:14.3f}\n")
            self._f.flush()
            return
        self._f.write(f"> {t.year:4d} {t.month:02d} {t.day:02d} {t.hour:02d} "
                      f"{t.minute:02d}{sec:11.7f}  0{len(observables):3d}\n")
        for o in observables:
            sys = _SYS_OF_SIGNAL[o.signal]
            self._f.write(
                f"{sys}{o.prn:02d}"
                f"{o.pseudorange_m:14.3f}  "
                f"{o.carrier_phase_cycles:14.3f}  "
                f"{o.doppler_hz:14.3f}  "
                f"{o.cn0_dbhz:14.3f}\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class RinexObsReader:
    """RINEX 3.x observation reader for the subset this framework writes
    (C/L/D/S per signal). Reference analog: the obs-input side of RTKLIB
    (rtklib_rinex); enough to replay logged epochs into the RTK engine.

    Returns epochs as (week_tow_tuple, [dict(system, prn, pseudorange_m,
    carrier_phase_cycles, doppler_hz, cn0_dbhz)]).
    """

    def __init__(self, path):
        self.path = pathlib.Path(path)

    def read_epochs(self) -> list:
        from gnss_sdr_tpu_torch.receiver.pvt.gpstime import gpsdatetime_to_gps
        out = []
        lines = self.path.read_text().splitlines()
        i = 0
        while i < len(lines) and "END OF HEADER" not in lines[i]:
            i += 1
        i += 1
        while i < len(lines):
            ln = lines[i]
            if not ln.startswith(">"):
                i += 1
                continue
            parts = ln[1:].split()
            y, mo, d, h, mi = map(int, parts[:5])
            sec = float(parts[5])
            n = int(parts[7])
            week, tow = gpsdatetime_to_gps(
                datetime.datetime(y, mo, d, h, mi, int(sec),
                                  int((sec % 1) * 1e6)))
            epoch = []
            for k in range(n):
                i += 1
                row = lines[i]
                epoch.append(dict(
                    system=row[0], prn=int(row[1:3]),
                    pseudorange_m=float(row[3:17]),
                    carrier_phase_cycles=float(row[19:33]),
                    doppler_hz=float(row[35:49]),
                    cn0_dbhz=float(row[51:65])))
            out.append(((week, tow), epoch))
            i += 1
        return out


class RinexNavWriter:
    """RINEX 3.02 mixed (or 2.11 GPS) navigation writer for GPS LNAV,
    Galileo I/NAV and BeiDou D1 (Kepler layouts with per-system trailing
    fields), GLONASS GNAV state-vector records (geph) and SBAS GEO state
    vectors (seph).

    Reference analog: the nav side of ``rinex_printer.cc`` (log_rinex_nav
    for Gps_Ephemeris / Galileo_Ephemeris / Glonass_Gnav_Ephemeris /
    Beidou_Dnav_Ephemeris) and SBAS GEO records.
    """

    def __init__(self, path, version: str = "3.02",
                 iono=None, utc=None, leap_seconds: int | None = None):
        """``version``: "3.02" (mixed) or "2.11" (GPS-only layout, the
        reference's PVT.rinex_version=2 path, rinex_printer.cc
        rinex_nav_header v2 builders). ``iono``/``utc``: IonoParams /
        UtcParams for the correction header lines."""
        self.path = pathlib.Path(path)
        self.version = str(version)
        self._f = open(self.path, "w")
        self._wrote_header = False
        self._written: set[tuple] = set()
        self._iono = iono
        self._utc = utc
        self._leap = leap_seconds

    def _header(self) -> None:
        f = self._f
        if self.version.startswith("2"):
            f.write(_hline("     2.11           N: GPS NAV DATA",
                           "RINEX VERSION / TYPE"))
        else:
            f.write(_hline("     3.02           N: GNSS NAV DATA    M: Mixed",
                           "RINEX VERSION / TYPE"))
        now = datetime.datetime.now(datetime.timezone.utc)
        f.write(_hline(f"gnss_sdr_tpu        CTTC-TPU            {now:%Y%m%d %H%M%S} UTC",
                       "PGM / RUN BY / DATE"))
        if self._iono is not None and getattr(self._iono, "valid", False):
            if self.version.startswith("2"):
                # v2.11: ION ALPHA / ION BETA (2X, 4D12.4)
                a = "".join(f"{v: 12.4E}".replace("E", "D")
                            for v in self._iono.alpha)
                b = "".join(f"{v: 12.4E}".replace("E", "D")
                            for v in self._iono.beta)
                f.write(_hline(f"  {a}", "ION ALPHA"))
                f.write(_hline(f"  {b}", "ION BETA"))
            else:
                a = "".join(f"{v: 12.4E}" for v in self._iono.alpha)
                b = "".join(f"{v: 12.4E}" for v in self._iono.beta)
                f.write(_hline(f"GPSA {a}", "IONOSPHERIC CORR"))
                f.write(_hline(f"GPSB {b}", "IONOSPHERIC CORR"))
        if self._utc is not None and getattr(self._utc, "valid", False):
            if self.version.startswith("2"):
                f.write(_hline(
                    f"   {self._utc.a0: 19.12E}{self._utc.a1: 19.12E}"
                    f"{int(self._utc.tot):9d}{int(self._utc.wnt):9d}"
                    .replace("E", "D"), "DELTA-UTC: A0,A1,T,W"))
            else:
                f.write(_hline(
                    f"GPUT {self._utc.a0: 17.10E}{self._utc.a1: 16.9E}"
                    f"{int(self._utc.tot):7d}{int(self._utc.wnt):5d}",
                    "TIME SYSTEM CORR"))
        leap = self._leap
        if leap is None and self._utc is not None and getattr(
                self._utc, "valid", False):
            leap = int(self._utc.delta_t_ls)
        if leap is not None:
            f.write(_hline(f"{leap:6d}", "LEAP SECONDS"))
        f.write(_hline("", "END OF HEADER"))
        self._wrote_header = True

    def _epoch_line(self, system: str, prn: int, t, a0, a1, a2) -> None:
        if self.version.startswith("2"):
            # v2.11 GPS nav: I2 PRN, 2-digit year, F5.1 seconds
            self._f.write(
                f"{prn:2d} {t.year % 100:02d} {t.month:2d} {t.day:2d} "
                f"{t.hour:2d} {t.minute:2d} {t.second + t.microsecond / 1e6:4.1f}"
                f"{_f1912(a0)}{_f1912(a1)}{_f1912(a2)}\n")
            return
        self._f.write(
            f"{system}{prn:02d} {t.year:4d} {t.month:02d} {t.day:02d} "
            f"{t.hour:02d} {t.minute:02d} {t.second:02d}"
            f"{_f1912(a0)}{_f1912(a1)}{_f1912(a2)}\n")

    def _line(self, *vals) -> None:
        # v2.11 orbit lines are indented 3 columns, v3 records 4
        pad = "   " if self.version.startswith("2") else "    "
        self._f.write(pad + "".join(_f1912(v) for v in vals) + "\n")

    def write_ephemeris(self, eph, system: str = "G",
                        glonass_date: datetime.date | None = None) -> None:
        """Append one broadcast record. ``eph`` is a KeplerEphemeris for
        G/E/C or a GlonassEphemeris (detected by its ``tb_s`` attribute)
        for R; ``glonass_date`` gives the UTC date of the geph epoch (the
        GNAV strings carry only time-of-day)."""
        if hasattr(eph, "tb_s"):                        # GLONASS geph
            if self.version.startswith("2"):
                raise ValueError(
                    "RINEX 2.11 nav files are GPS-only ('N: GPS NAV DATA');"
                    " write GLONASS geph to a 3.02 file")
            self._write_geph(eph, glonass_date)
            return
        if hasattr(eph, "agf0_s"):                      # SBAS GEO (MT9)
            if self.version.startswith("2"):
                raise ValueError(
                    "RINEX 2.11 nav files are GPS-only; write SBAS GEO "
                    "records to a 3.02 file")
            self._write_seph(eph, glonass_date)
            return
        if self.version.startswith("2") and system != "G":
            raise ValueError(
                f"RINEX 2.11 nav files are GPS-only; system {system!r} "
                "needs version 3.02")
        if system not in ("G", "E", "C"):
            raise ValueError(
                f"no RINEX nav layout for system {system!r} with a Kepler "
                "ephemeris (GLONASS needs a GlonassEphemeris record)")
        key = (system, eph.prn, eph.iode, eph.toe)
        if key in self._written:
            return
        self._written.add(key)
        if not self._wrote_header:
            self._header()
        t = gps_to_gpsdatetime(eph.week, eph.toc)
        self._epoch_line(system, eph.prn, t, eph.af0, eph.af1, eph.af2)
        self._line(float(eph.iode), eph.crs, eph.delta_n, eph.m0)
        self._line(eph.cuc, eph.e, eph.cus, eph.sqrt_a)
        self._line(eph.toe, eph.cic, eph.omega0, eph.cis)
        self._line(eph.i0, eph.crc, eph.omega, eph.omega_dot)
        if system == "G":
            self._line(eph.idot, 1.0, float(eph.week), 0.0)
            self._line(float(eph.ura), float(eph.health), eph.tgd,
                       float(eph.iodc))
            self._line(eph.toe, 4.0)
        elif system == "E":
            # data sources 0x0201 = I/NAV E1-B; BGD E5a/E1 in the tgd slot
            self._line(eph.idot, 513.0, float(eph.week), 0.0)
            self._line(float(eph.ura), float(eph.health), eph.tgd, 0.0)
            self._line(eph.toe, 0.0)
        else:                                            # BeiDou D1
            self._line(eph.idot, 0.0, float(eph.week), 0.0)
            self._line(float(eph.ura), float(eph.health), eph.tgd, 0.0)
            self._line(eph.toe, float(eph.iodc))
        self._f.flush()

    def _write_geph(self, g, date: datetime.date | None) -> None:
        key = ("R", g.slot, g.tb_s)
        if key in self._written:
            return
        self._written.add(key)
        if not self._wrote_header:
            self._header()
        # geph epoch: tb is Moscow time (UTC+3h); RINEX wants UTC
        utc_sec = (g.tb_s - 10800.0) % 86400.0
        date = date or datetime.date(2020, 1, 1)
        hh = int(utc_sec // 3600)
        mm = int((utc_sec % 3600) // 60)
        ss = int(utc_sec % 60)
        # header line: -tau_n, gamma_n, message frame time
        self._f.write(
            f"R{g.slot:02d} {date.year:4d} {date.month:02d} {date.day:02d} "
            f"{hh:02d} {mm:02d} {ss:02d}"
            f"{_f1912(-g.tau_n)}{_f1912(g.gamma_n)}{_f1912(0.0)}\n")
        # pos/vel/acc in KM (RINEX geph convention), health / freq slot / age
        p, v, a = g.pos_m, g.vel_m_s, g.acc_m_s2
        self._line(p[0] / 1e3, v[0] / 1e3, a[0] / 1e3, float(g.health))
        self._line(p[1] / 1e3, v[1] / 1e3, a[1] / 1e3, float(g.freq_slot))
        self._line(p[2] / 1e3, v[2] / 1e3, a[2] / 1e3, 0.0)
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def _write_seph(self, s, date: datetime.date | None) -> None:
        """SBAS 'S' navigation record (rinex_printer.cc log_rinex_nav for
        Sbas_Ephemeris): epoch + aGf0/aGf1/transmission time, then the
        ECEF state vector in km with health/URA/IODN trailers. RINEX SBAS
        PRNs are offset by 100 (S20 = PRN 120)."""
        key = ("S", s.prn, s.t0_s)
        if key in self._written:
            return
        self._written.add(key)
        if not self._wrote_header:
            self._header()
        date = date or datetime.date(2020, 1, 1)
        hh = int(s.t0_s // 3600)
        mm = int((s.t0_s % 3600) // 60)
        ss = int(s.t0_s % 60)
        self._f.write(
            f"S{s.prn - 100:02d} {date.year:4d} {date.month:02d} "
            f"{date.day:02d} {hh:02d} {mm:02d} {ss:02d}"
            f"{_f1912(s.agf0_s)}{_f1912(s.agf1_s_s)}{_f1912(s.t0_s)}\n")
        p, v, a = s.pos_m, s.vel_m_s, s.acc_m_s2
        self._line(p[0] / 1e3, v[0] / 1e3, a[0] / 1e3, 0.0)   # health
        self._line(p[1] / 1e3, v[1] / 1e3, a[1] / 1e3, float(s.ura))
        self._line(p[2] / 1e3, v[2] / 1e3, a[2] / 1e3, float(s.iodn))
        self._f.flush()


class RinexNavReader:
    """RINEX 3.x mixed / 2.11 navigation reader for GPS LNAV, Galileo I/NAV,
    BeiDou D1 and GLONASS geph records.

    Reference analog: RTKLIB's ``readrnx`` nav branch (rtklib_rinex).
    Returns a dict keyed (system, prn) -> ephemeris (latest record wins);
    records of other systems raise ``NotImplementedError``.
    """

    def __init__(self, path):
        self.path = pathlib.Path(path)

    @staticmethod
    def _floats(s: str, n: int, start: int = 4) -> list:
        out = []
        for i in range(n):
            chunk = s[start + 19 * i: start + 19 * (i + 1)] \
                .replace("D", "E").strip()
            out.append(float(chunk) if chunk else 0.0)
        return out

    def read(self) -> dict:
        from gnss_sdr_tpu_torch import constants as C
        from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris
        from gnss_sdr_tpu_torch.models.nav.glonass_gnav import GlonassEphemeris
        from gnss_sdr_tpu_torch.receiver.pvt.gpstime import gpsdatetime_to_gps

        lines = self.path.read_text().splitlines()
        v2 = bool(lines) and lines[0][:9].strip().startswith("2")
        i = 0
        while i < len(lines) and "END OF HEADER" not in lines[i]:
            i += 1
        i += 1
        out: dict = {}
        while i < len(lines):
            ln = lines[i]
            if v2:
                # 2.11 GPS-only layout: I2 PRN, 2-digit year, F5.1 seconds
                if len(ln) < 23 or not ln[:2].strip().isdigit():
                    i += 1
                    continue
                system = "G"
                prn = int(ln[:2])
                yy = int(ln[3:5])
                y = yy + (2000 if yy < 80 else 1900)
                mo, d, h, mi = (int(ln[6:8]), int(ln[9:11]),
                                int(ln[12:14]), int(ln[15:17]))
                s = int(float(ln[17:22]))
                a = [float(ln[22 + 19 * k: 22 + 19 * (k + 1)]
                           .replace("D", "E")) for k in range(3)]
                rows = [self._floats(lines[i + k], 4, start=3)
                        for k in range(1, 7)]
                tail = (self._floats(lines[i + 7], 2, start=3)
                        if i + 7 < len(lines) else [0.0, 0.0])
                week = int(rows[4][2])
                _, toc = gpsdatetime_to_gps(
                    datetime.datetime(y, mo, d, h, mi, s))
                out[("G", prn)] = KeplerEphemeris(
                    prn=prn, week=week, toc=toc,
                    af0=a[0], af1=a[1], af2=a[2],
                    iode=int(rows[0][0]), crs=rows[0][1],
                    delta_n=rows[0][2], m0=rows[0][3],
                    cuc=rows[1][0], e=rows[1][1], cus=rows[1][2],
                    sqrt_a=rows[1][3],
                    toe=rows[2][0], cic=rows[2][1], omega0=rows[2][2],
                    cis=rows[2][3],
                    i0=rows[3][0], crc=rows[3][1], omega=rows[3][2],
                    omega_dot=rows[3][3],
                    idot=rows[4][0],
                    ura=int(rows[5][0]), health=int(rows[5][1]),
                    tgd=rows[5][2], iodc=int(rows[5][3]))
                i += 8
                continue
            if len(ln) < 23 or ln[0] not in "GECR":
                i += 1
                continue
            system = ln[0]
            prn = int(ln[1:3])
            y, mo, d, h, mi, s = (int(ln[4:8]), int(ln[9:11]), int(ln[12:14]),
                                  int(ln[15:17]), int(ln[18:20]),
                                  int(ln[21:23]))
            a = [float(ln[23 + 19 * k: 23 + 19 * (k + 1)].replace("D", "E"))
                 for k in range(3)]
            if system == "R":
                r1 = self._floats(lines[i + 1], 4)
                r2 = self._floats(lines[i + 2], 4)
                r3 = self._floats(lines[i + 3], 4)
                utc_sec = h * 3600 + mi * 60 + s
                out[("R", prn)] = GlonassEphemeris(
                    slot=prn, freq_slot=int(r2[3]),
                    tb_s=(utc_sec + 10800.0) % 86400.0,
                    pos_m=(r1[0] * 1e3, r2[0] * 1e3, r3[0] * 1e3),
                    vel_m_s=(r1[1] * 1e3, r2[1] * 1e3, r3[1] * 1e3),
                    acc_m_s2=(r1[2] * 1e3, r2[2] * 1e3, r3[2] * 1e3),
                    tau_n=-a[0], gamma_n=a[1], health=int(r1[3]))
                i += 4
                continue
            rows = [self._floats(lines[i + k], 4) for k in range(1, 7)]
            tail = self._floats(lines[i + 7], 2) if i + 7 < len(lines) else [0.0, 0.0]
            week = int(rows[4][2])
            _, toc = gpsdatetime_to_gps(
                datetime.datetime(y, mo, d, h, mi, s))
            eph = KeplerEphemeris(
                prn=prn, week=week, toc=toc,
                af0=a[0], af1=a[1], af2=a[2],
                iode=int(rows[0][0]), crs=rows[0][1], delta_n=rows[0][2],
                m0=rows[0][3],
                cuc=rows[1][0], e=rows[1][1], cus=rows[1][2],
                sqrt_a=rows[1][3],
                toe=rows[2][0], cic=rows[2][1], omega0=rows[2][2],
                cis=rows[2][3],
                i0=rows[3][0], crc=rows[3][1], omega=rows[3][2],
                omega_dot=rows[3][3],
                idot=rows[4][0],
                ura=int(rows[5][0]), health=int(rows[5][1]), tgd=rows[5][2],
                iodc=int(rows[5][3]))
            if system == "E":
                eph.gm = C.GM_EARTH_GAL
            elif system == "C":
                eph.gm = C.GM_EARTH_BDS
            out[(system, prn)] = eph
            i += 8
        return out
