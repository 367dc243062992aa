"""rinex2assist: convert RINEX 3 navigation files into assistance JSON.

Port of gnss_sdr_tpu/utils/rinex2assist.py (host code, copied with its
imports rewritten): ``python -m gnss_sdr_tpu_torch.utils.rinex2assist``.

Reference analog: ``src/utils/rinex2assist/main.cc`` (RINEX nav -> XML
assistance for warm/hot start). Parses the GPS/Galileo/BeiDou Kepler records
our RinexNavWriter emits (and standard IGS BRDC files of that shape).
"""

from __future__ import annotations

import pathlib

from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris
from gnss_sdr_tpu_torch import constants as C


def _f(s: str) -> float:
    return float(s.replace("D", "E").replace("d", "e"))


def parse_rinex_nav(path) -> dict[str, dict[int, KeplerEphemeris]]:
    """Parse a RINEX 3 nav file -> {system_letter: {prn: ephemeris}}.

    Keeps the newest record (largest toe) per satellite.
    """
    lines = pathlib.Path(path).read_text().splitlines()
    # skip header
    i = 0
    while i < len(lines) and "END OF HEADER" not in lines[i]:
        i += 1
    i += 1
    out: dict[str, dict[int, KeplerEphemeris]] = {}
    while i + 7 < len(lines):
        hdr = lines[i]
        if not hdr[:1] in ("G", "E", "C", "J", "I"):
            i += 1
            continue
        sys = hdr[0]
        prn = int(hdr[1:3])
        af0, af1, af2 = (_f(hdr[23 + 19 * k: 23 + 19 * (k + 1)]) for k in range(3))
        orb = []
        for r in range(1, 8):
            line = lines[i + r]
            for k in range(4):
                fld = line[4 + 19 * k: 4 + 19 * (k + 1)].strip()
                orb.append(_f(fld) if fld else 0.0)
        (iode, crs, delta_n, m0,
         cuc, e, cus, sqrt_a,
         toe, cic, omega0, cis,
         i0, crc, omega, omega_dot,
         idot, _codes, week, _l2p,
         ura, health, tgd, iodc) = orb[:24]
        gm = C.GM_EARTH if sys == "G" else C.GM_EARTH_GAL
        eph = KeplerEphemeris(
            prn=prn, week=int(week), toe=toe, toc=toe,
            af0=af0, af1=af1, af2=af2, tgd=tgd,
            iode=int(iode), iodc=int(iodc), ura=int(ura), health=int(health),
            crs=crs, delta_n=delta_n, m0=m0, cuc=cuc, e=e, cus=cus,
            sqrt_a=sqrt_a, cic=cic, omega0=omega0, cis=cis, i0=i0, crc=crc,
            omega=omega, omega_dot=omega_dot, idot=idot, gm=gm)
        cur = out.setdefault(sys, {})
        if prn not in cur or eph.toe >= cur[prn].toe:
            cur[prn] = eph
        i += 8
    return out


def rinex2assist(nav_path, out_path, system: str = "G") -> int:
    """Write assistance JSON from a RINEX nav file; returns #satellites."""
    from gnss_sdr_tpu_torch.receiver.control import save_assistance
    all_sys = parse_rinex_nav(nav_path)
    ephs = all_sys.get(system, {})
    save_assistance(out_path, ephs)
    return len(ephs)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="rinex2assist")
    p.add_argument("nav_file")
    p.add_argument("-o", "--output", default="assistance.json")
    p.add_argument("--system", default="G")
    a = p.parse_args(argv)
    n = rinex2assist(a.nav_file, a.output, a.system)
    print(f"wrote {n} ephemerides to {a.output}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
