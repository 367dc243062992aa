"""Position accuracy/precision statistics (static system-test metrics).

Reference analog: ``position_test.cc:563-599`` — after an end-to-end run the
reference computes the classic radial accuracy measures over the ENU error
series and prints/asserts them: DRMS / 2DRMS (horizontal RMS radii), CEP
(median horizontal circle), MRSE/SEP (3D), and the 90% / 99% spherical
accuracy standards. Same definitions here, over an [N, 3] ENU error array.
"""

from __future__ import annotations

import numpy as np


def position_statistics(enu_errors: np.ndarray) -> dict:
    """Accuracy measures from an [N, 3] array of ENU position errors.

    Offsets are measured about the TRUTH (accuracy, like the reference's
    static run against the known antenna position); precision about the
    mean is obtained by passing ``enu - enu.mean(0)``.
    """
    enu = np.asarray(enu_errors, float)
    if enu.ndim != 2 or enu.shape[1] != 3:
        raise ValueError("expected [N, 3] ENU errors")
    e, n, u = enu[:, 0], enu[:, 1], enu[:, 2]
    se, sn, su = np.mean(e * e), np.mean(n * n), np.mean(u * u)
    horiz = np.hypot(e, n)
    r3 = np.linalg.norm(enu, axis=1)
    drms = float(np.sqrt(se + sn))
    return {
        "mean_enu": enu.mean(axis=0),
        "drms": drms,                         # horizontal RMS radius
        "2drms": 2.0 * drms,
        "cep": float(np.percentile(horiz, 50.0)),
        "mrse": float(np.sqrt(se + sn + su)),  # 3D RMS radius
        "sep": float(np.percentile(r3, 50.0)),
        "sas_90": float(np.percentile(r3, 90.0)),
        "sas_99": float(np.percentile(r3, 99.0)),
    }


def format_statistics(stats: dict, label: str = "") -> str:
    """Human-readable block, mirroring the reference's console report."""
    m = stats["mean_enu"]
    return (f"--- position accuracy {label} ---\n"
            f" mean ENU offset: {m[0]:+.3f} {m[1]:+.3f} {m[2]:+.3f} m\n"
            f" DRMS {stats['drms']:.3f} m   2DRMS {stats['2drms']:.3f} m   "
            f"CEP {stats['cep']:.3f} m\n"
            f" MRSE {stats['mrse']:.3f} m   SEP {stats['sep']:.3f} m   "
            f"90% SAS {stats['sas_90']:.3f} m   "
            f"99% SAS {stats['sas_99']:.3f} m")
