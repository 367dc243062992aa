"""Per-stage internal-state dumps — the receiver's tracing system.

Reference analog: every block's ``dump=true`` binary/.mat output
(``dll_pll_veml_tracking.cc:1327 save_matfile``, ``pcps_acquisition.cc:427``,
observables/PVT dumps) used as the de-facto tracing/debugging system and as
test oracles (the dump readers under src/tests/.../libs/*_dump_reader.*).

Here: npz archives (+ a MATLAB .mat through scipy with ``mat=True``), one
file per stage, accumulated in memory and written on close. A copy of
gnss_sdr_tpu/io/dumps.py: the same classes, fields and files, so the dump
readers of both packages read either's dumps.
"""

from __future__ import annotations

import pathlib

import numpy as np


class StageDump:
    """Accumulates named arrays per push and saves one npz per stage.

    ``mat=True`` additionally writes a MATLAB ``.mat`` next to the npz
    (reference save_matfile parity for the utils/matlab helpers).
    """

    def __init__(self, path: str | pathlib.Path, mat: bool = False):
        self.path = pathlib.Path(path)
        self.mat = mat
        self._records: dict[str, list] = {}

    def push(self, **arrays) -> None:
        for k, v in arrays.items():
            self._records.setdefault(k, []).append(np.asarray(v))

    def close(self) -> None:
        if not self._records:
            return
        out = {}
        for k, vals in self._records.items():
            try:
                out[k] = np.concatenate([np.atleast_1d(v) for v in vals])
            except ValueError:
                out[k] = np.array(vals, dtype=object)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(self.path, **out)
        if self.mat:
            from scipy.io import savemat
            savemat(self.path.with_suffix(".mat"),
                    {k: v for k, v in out.items() if v.dtype != object})


class TrackingDump(StageDump):
    """Per-epoch tracking internals for one channel (dump-reader compatible
    field names mirror the reference's tracking dump: prompt I/Q, E/L, CN0,
    Doppler, code phase, sample stamp)."""

    def push_epochs(self, ch_id: int, prn: int, abs_samples, epoch_idx,
                    prompts, cn0, carrier_freq, code_freq, rem_code_phase,
                    carrier_lock) -> None:
        self.push(channel=np.full(len(epoch_idx), ch_id, np.int32),
                  prn=np.full(len(epoch_idx), prn, np.int32),
                  abs_sample=abs_samples, epoch=epoch_idx,
                  prompt_i=np.real(prompts), prompt_q=np.imag(prompts),
                  cn0_dbhz=cn0, carrier_doppler_hz=carrier_freq,
                  code_freq_cps=code_freq, rem_code_phase_chips=rem_code_phase,
                  carrier_lock=carrier_lock)


class AcquisitionDump(StageDump):
    """Per-attempt acquisition statistics (reference
    ``pcps_acquisition.cc:427 dump_results``: the grid reduction per
    satellite and dwell — here one row per candidate per batch)."""

    def push_batch(self, signal: str, chunk_index: int, prns, test_cfar,
                   test_max_power, code_phase, doppler_hz, magnitude,
                   threshold: float) -> None:
        n = len(prns)
        self.push(signal=np.array([signal] * n, dtype="<U2"),
                  chunk=np.full(n, chunk_index, np.int64),
                  prn=np.asarray(prns, np.int32),
                  test_cfar=np.asarray(test_cfar, np.float32),
                  test_max_power=np.asarray(test_max_power, np.float32),
                  code_phase=np.asarray(code_phase, np.int32),
                  doppler_hz=np.asarray(doppler_hz, np.float32),
                  magnitude=np.asarray(magnitude, np.float32),
                  threshold=np.full(n, threshold, np.float32),
                  positive=np.asarray(test_cfar, np.float32) >= threshold)


class ObservablesDump(StageDump):
    def push_epoch(self, tick_sample: int, observables) -> None:
        for o in observables:
            self.push(tick_sample=np.int64(tick_sample), prn=np.int32(o.prn),
                      pseudorange_m=o.pseudorange_m,
                      carrier_phase_cycles=o.carrier_phase_cycles,
                      doppler_hz=o.doppler_hz, t_tx_sv=o.t_tx_sv,
                      cn0_dbhz=o.cn0_dbhz)


class PvtDump(StageDump):
    def push_fix(self, sol) -> None:
        self.push(tow_s=sol.tow_s, x=sol.pos_ecef[0], y=sol.pos_ecef[1],
                  z=sol.pos_ecef[2], vx=sol.vel_ecef[0], vy=sol.vel_ecef[1],
                  vz=sol.vel_ecef[2], clock_bias_s=sol.clock_bias_s,
                  n_sats=np.int32(sol.n_sats), pdop=sol.pdop, hdop=sol.hdop)


def load_dump(path) -> dict:
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}
