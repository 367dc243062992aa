"""SP3 precise ephemeris: reader, writer and an interpolating provider.

The port's copy of gnss_sdr_tpu/receiver/pvt/sp3.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: ``src/algorithms/libs/rtklib/rtklib_preceph.cc``
(readsp3/peph2pos): SP3-c files carry satellite positions (km) and clocks
(microseconds) at fixed epochs; positioning interpolates positions with a
high-order polynomial and clocks linearly. The provider exposes the same
``position_velocity(t)/clock_offset(t)`` protocol as broadcast ephemerides,
so ``solver.solve_pvt`` consumes it unchanged.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from gnss_sdr_tpu_torch.receiver.pvt.gpstime import (gps_to_gpsdatetime,
                                               gpsdatetime_to_gps)


@dataclasses.dataclass
class Sp3Record:
    tow: float                 # seconds of week (GPS time)
    pos_m: np.ndarray          # [3] ECEF meters
    clock_s: float             # satellite clock offset, seconds


class Sp3Ephemeris:
    """Interpolating precise ephemeris for ONE satellite.

    Positions: Lagrange interpolation over ``order+1`` surrounding epochs
    (RTKLIB uses 10-point Neville); clock: linear between epochs. Velocity
    from the analytic derivative of the Lagrange basis.
    """

    def __init__(self, records: list[Sp3Record], order: int = 8,
                 prn: int = 0, week: int = 0):
        self.records = sorted(records, key=lambda r: r.tow)
        self.order = order
        self.prn = prn
        self.week = week
        self._t = np.array([r.tow for r in self.records])
        self._p = np.stack([r.pos_m for r in self.records])
        self._c = np.array([r.clock_s for r in self.records])

    def _window(self, t: float) -> slice:
        n = len(self._t)
        m = self.order + 1
        i = int(np.searchsorted(self._t, t))
        lo = max(0, min(i - m // 2, n - m))
        return slice(lo, lo + m)

    def position_velocity(self, t: float) -> tuple[np.ndarray, np.ndarray]:
        w = self._window(t)
        ts = self._t[w]
        ps = self._p[w]
        m = len(ts)
        pos = np.zeros(3)
        vel = np.zeros(3)
        for j in range(m):
            lj = 1.0
            dlj = 0.0
            for k in range(m):
                if k == j:
                    continue
                lj *= (t - ts[k]) / (ts[j] - ts[k])
            for i in range(m):
                if i == j:
                    continue
                term = 1.0 / (ts[j] - ts[i])
                for k in range(m):
                    if k in (i, j):
                        continue
                    term *= (t - ts[k]) / (ts[j] - ts[k])
                dlj += term
            pos += lj * ps[j]
            vel += dlj * ps[j]
        return pos, vel

    def clock_offset(self, t: float) -> float:
        i = int(np.clip(np.searchsorted(self._t, t), 1, len(self._t) - 1))
        t0, t1 = self._t[i - 1], self._t[i]
        a = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        return float((1 - a) * self._c[i - 1] + a * self._c[i])


def read_sp3(path) -> dict:
    """Parse an SP3-c file -> {(system, prn): Sp3Ephemeris}."""
    sats: dict = {}
    week = 0
    tow = 0.0
    for line in pathlib.Path(path).read_text().splitlines():
        if line.startswith("*"):
            parts = line[1:].split()
            y, mo, d, h, mi = map(int, parts[:5])
            sec = float(parts[5])
            import datetime
            week, tow = gpsdatetime_to_gps(datetime.datetime(
                y, mo, d, h, mi, int(sec), int((sec % 1) * 1e6)))
        elif line.startswith("P") and len(line) > 4:
            system = line[1]
            prn = int(line[2:4])
            f = line[4:].split()
            pos = np.array([float(f[0]), float(f[1]), float(f[2])]) * 1e3
            clk = float(f[3]) * 1e-6
            if abs(clk) > 0.9:          # 999999.999999 = no clock
                clk = 0.0
            sats.setdefault((system, prn), []).append(
                Sp3Record(tow=tow, pos_m=pos, clock_s=clk))
    return {k: Sp3Ephemeris(v, prn=k[1], week=week)
            for k, v in sats.items()}


def write_sp3(path, epochs: list, week: int) -> None:
    """Minimal SP3-c writer (test oracle / interchange).

    epochs: list of (tow, {(system, prn): (pos_m[3], clock_s)}).
    """
    lines = []
    t0 = gps_to_gpsdatetime(week, epochs[0][0])
    n_sats = len(epochs[0][1])
    lines.append(f"#cP{t0.year:5d} {t0.month:2d} {t0.day:2d} {t0.hour:2d} "
                 f"{t0.minute:2d} {t0.second:11.8f} {len(epochs):7d} ORBIT "
                 f"IGS14 FIT  TPU")
    lines.append(f"+  {n_sats:4d}   " + "".join(
        f"{s}{p:02d}" for (s, p) in sorted(epochs[0][1])[:17]))
    lines.append("%c G  cc GPS ccc cccc cccc cccc cccc ccccc ccccc ccccc ccccc")
    for tow, sats in epochs:
        t = gps_to_gpsdatetime(week, tow)
        lines.append(f"*  {t.year:4d} {t.month:2d} {t.day:2d} {t.hour:2d} "
                     f"{t.minute:2d} {t.second + t.microsecond / 1e6:11.8f}")
        for (system, prn), (pos, clk) in sorted(sats.items()):
            x, y, z = np.asarray(pos) / 1e3
            lines.append(f"P{system}{prn:02d}{x:14.6f}{y:14.6f}{z:14.6f}"
                         f"{clk * 1e6:14.6f}")
    lines.append("EOF")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
