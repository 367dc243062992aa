"""Dump-file reader/plotter library.

Reference analog: the MATLAB helper library under ``src/utils/matlab``
(``dll_pll_veml_read_tracking_dump.m``, ``gps_l1_ca_pvt_read_pvt_dump.m``,
plot scripts) — the de-facto analysis workflow for the reference's
per-block ``dump=true`` files. Here the dumps are npz (+ optional .mat,
``io/dumps.py``) and the helpers are plain Python/matplotlib:

    from gnss_sdr_tpu_torch.utils import dump_tools
    trk = dump_tools.read_tracking("dumps/tracking.npz")
    dump_tools.plot_tracking(trk, prn=17, out="prn17.png")

CLI: ``python -m gnss_sdr_tpu_torch.utils.dump_tools <dump_dir> [--out plots/]``
renders the standard panel set (per-channel CN0/Doppler, acquisition
grid statistics, ENU scatter of fixes). A copy of
gnss_sdr_tpu/utils/dump_tools.py; matplotlib is imported only inside the
plot functions, so the readers run where it is not installed.
"""

from __future__ import annotations

import pathlib

import numpy as np

from gnss_sdr_tpu_torch.io.dumps import load_dump


def read_tracking(path) -> dict:
    """Per-channel tracking time series: {prn: {field: array}}."""
    d = load_dump(path)
    out: dict = {}
    prns = np.asarray(d["prn"])
    for prn in np.unique(prns):
        m = prns == prn
        out[int(prn)] = {k: np.asarray(v)[m] for k, v in d.items()}
    return out


def read_acquisition(path) -> dict:
    return load_dump(path)


def read_observables(path) -> dict:
    return load_dump(path)


def read_pvt(path) -> dict:
    return load_dump(path)


def pvt_enu(pvt: dict, ref_ecef=None):
    """ENU errors of the dumped fixes about ``ref_ecef`` (default: the
    mean fix) — the position_test scatter input."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy

    pos = np.stack([np.asarray(pvt["x"]), np.asarray(pvt["y"]),
                    np.asarray(pvt["z"])], axis=-1)
    ref = np.asarray(ref_ecef) if ref_ecef is not None else pos.mean(axis=0)
    lat, lon, _ = geodesy.ecef_to_geodetic(ref)
    return np.stack([geodesy.ecef_to_enu(p - ref, lat, lon) for p in pos])


def plot_tracking(trk: dict, prn: int | None = None, out=None):
    """CN0 / Doppler / prompt-IQ panels per channel (matplotlib Figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sel = [prn] if prn is not None else sorted(trk)
    fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
    for p in sel:
        t = trk[p]
        x = np.asarray(t["abs_sample"], float)
        axes[0].plot(x, t["cn0_dbhz"], label=f"PRN {p}")
        axes[1].plot(x, t["carrier_doppler_hz"])
        axes[2].plot(x, t["prompt_i"], lw=0.5)
    axes[0].set_ylabel("C/N0 [dB-Hz]")
    axes[1].set_ylabel("carrier freq [Hz]")
    axes[2].set_ylabel("prompt I")
    axes[2].set_xlabel("sample")
    axes[0].legend(loc="lower right", fontsize=7)
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=110)
        plt.close(fig)
    return fig


def plot_pvt(pvt: dict, ref_ecef=None, out=None):
    """ENU scatter + error time series of the dumped fixes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    enu = pvt_enu(pvt, ref_ecef)
    fig, (a, b) = plt.subplots(1, 2, figsize=(10, 4.5))
    a.scatter(enu[:, 0], enu[:, 1], s=4)
    a.set_xlabel("E [m]"); a.set_ylabel("N [m]"); a.axis("equal")
    a.set_title("horizontal scatter")
    b.plot(np.linalg.norm(enu, axis=1))
    b.set_xlabel("fix #"); b.set_ylabel("3D error about ref [m]")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=110)
        plt.close(fig)
    return fig


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="gnss-sdr-tpu-torch-dump-tools")
    p.add_argument("dump_dir")
    p.add_argument("--out", default="plots")
    args = p.parse_args(argv)
    d = pathlib.Path(args.dump_dir)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    made = []
    if (d / "tracking.npz").exists():
        trk = read_tracking(d / "tracking.npz")
        plot_tracking(trk, out=outdir / "tracking.png")
        made.append("tracking.png")
    if (d / "pvt.npz").exists():
        pvt = read_pvt(d / "pvt.npz")
        if len(np.atleast_1d(pvt.get("x", []))):
            plot_pvt(pvt, out=outdir / "pvt.png")
            made.append("pvt.png")
    print(f"wrote {', '.join(made) if made else 'nothing (no dumps found)'} "
          f"to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
