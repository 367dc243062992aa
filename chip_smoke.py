"""Chip smoke test of the PyTorch / CUDA port (gnss_sdr_tpu_torch) on one GPU.

    python3 chip_smoke.py          # on a machine with an NVIDIA card (H100)
    python3 chip_smoke.py --cpu    # rehearsal on the CPU: plain versions only,
                                   # a short main path and CLI run, no result
                                   # line

Phases, one line each, with their seconds:

1. device   the card's name, the device count, nvidia-smi's name and power
            limit; exits non-zero without a card.
2. build    every CUDA kernel, compiled with nvcc from gnss_sdr_tpu_torch/csrc
            into build/kernels, one nvcc per source started together (the
            -Xptxas -v register / shared-memory report is printed).
3. K1       the epoch multicorrelator kernel against its plain PyTorch
            version on the same card tensors, at four shapes: (a) the GPS L1
            tracking shape C=8, K=3, n_max=2064, Lt=1023; (b) C=128; (c) BOC
            table_rate=2, K=5, Lt=8184; (d) channels with n_samp=0. Fails
            beyond rtol 2e-4 / atol 2e-3 (the tolerance of
            tests/test_correlator.py).
4. K2       the fused tracking kernel against its plain version (the eager
            loop with the plain correlator) from the same carry on the same
            chunk: the open-loop handoff of 5 satellites on 6 channels, plain
            and with extended integration + a secondary code (102 steps,
            pull-in reaching WIDE at step 100), and a dispatch of 16 chunks
            (1602 steps); after the main phase, the receiver's final carry
            (channels in NARROW_TRACK). Packed int32 columns, valid, the loss
            flag and the carry's int / bool fields equal; float columns and
            float carry fields within rtol 1e-4 / atol 1e-4; the prompt
            within |dz| <= 1e-4 |z| + 1e-4 (tests/test_torch_tracking.py's
            tolerances).
5. timing   K1 and its plain version at shapes (a) and (b), CUDA events over
            500 launches each after a warm-up, in turns (plain, kernel,
            kernel, plain), beside the bound computed from the shapes; K2
            per 100 ms chunk at C=8 and C=128, in turns with the eager loop
            on the plain correlator and the eager loop on K1, beside K2's
            bound.
6. main     the port's receiver on a generated 28 s, 6-satellite, 47 dB-Hz
            GPS L1 C/A scenario at 2 MSps (seed 123): all satellites tracked,
            ephemerides decoded, fixes within 2D < 2 m / 3D < 5 m of the
            truth, one K2 launch per tracking dispatch and no K1 launch;
            with the host seconds of each receiver stage. Then the streaming
            configuration (dispatch_chunks=16, upload_bits=4,
            pipeline_depth=4) on the first 12 s: every satellite tracked.
7. profile  the receiver's own dispatch on its final carry: host and device
            ms per 100 ms chunk (torch.profiler), the device's busy share,
            device operations per chunk, K2's share of the device time; and
            the host time to enqueue one dispatch, in turns, with the carry
            kept packed on the device (the receiver's form) and with the
            TrackingState packed and unpacked around each launch.
8. cli      the port's CLI, ``python3 -m gnss_sdr_tpu_torch -c <conf>``, as a
            subprocess: the main phase's capture written as ishort into a
            temporary directory, a conf built from conf/gps_l1_file.conf at
            2 MSps with NMEA, KML and RINEX obs / nav output (PVT.trop_model
            and iono_model OFF, as the main phase's solver): exit 0, a device
            line naming cuda, the last fix within 2D < 2 m / 3D < 5 m, GGA
            sentences, the 6 PRNs in the RINEX obs file, the RINEX nav
            file's ephemerides equal to the main phase's, one K2 launch per
            tracking dispatch. Then the shipped conf/gps_l1_file.conf rates
            (4 MSps conditioned to 2 MSps) on 2 s of the scenario generated
            at 4 MSps, --max_chunks 20: all 6 PRNs acquired and tracking.

The line before the last two is the kernels' JSON record, then the card's
name and power limit, then the result line. Float32 matrix products run in
full float32 (TF32 off) so the plain versions are exact references.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# float32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

RTOL, ATOL = 2e-4, 2e-3
FS = 2.0e6


def _line(phase: str, t0: float, **kv) -> None:
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {items} seconds={time.perf_counter() - t0:.3f}",
          flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- K1 ---
def k1_inputs(seed: int, n_ch: int, n_taps: int, n_max: int, code_len: int,
              table_rate: int, fs: float, n_zero: int = 0, device="cpu"):
    """Random multicorrelator inputs at a tracking-loop shape: windows at
    random offsets of a chunk of n_max*100 samples (+ halo), epoch lengths of
    one code period, code phases / Dopplers of a live channel."""
    rng = np.random.default_rng(seed)
    chunk_len = n_max * 100
    length = chunk_len + n_max
    spc = code_len * fs / 1.023e6
    n_samp = rng.integers(int(spc) - 4, int(spc) + 4, n_ch).astype(np.int32)
    n_samp[rng.permutation(n_ch)[:n_zero]] = 0
    taps = {3: [-0.5, 0.0, 0.5], 5: [-0.6, -0.15, 0.0, 0.15, 0.6]}[n_taps]
    arrays = dict(
        chunk=rng.standard_normal((length, 2)).astype(np.float32),
        offsets=rng.integers(0, chunk_len, n_ch).astype(np.int32),
        n_samples=n_samp,
        code_tables=rng.choice([-1.0, 1.0],
                               (n_ch, code_len * table_rate)).astype(np.float32),
        rem_code_phases=rng.uniform(0.0, 0.5, n_ch).astype(np.float32),
        code_phase_steps=(1.023e6 * (1 + rng.uniform(-3e-6, 3e-6, n_ch))
                          / fs).astype(np.float32),
        carr_phase_fracs=rng.uniform(0.0, 1.0, n_ch).astype(np.float32),
        carr_phase_steps=(rng.uniform(-5e3, 5e3, n_ch) / fs).astype(np.float32),
        tap_offsets=np.asarray(taps, np.float32))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


K1_SHAPES = {
    "a_main_path": dict(seed=1, n_ch=8, n_taps=3, n_max=2064, code_len=1023,
                        table_rate=1, fs=FS),
    "b_c128": dict(seed=2, n_ch=128, n_taps=3, n_max=2064, code_len=1023,
                   table_rate=1, fs=FS),
    "c_boc": dict(seed=3, n_ch=8, n_taps=5, n_max=16064, code_len=4092,
                  table_rate=2, fs=4.0e6),
    "d_nsamp0": dict(seed=4, n_ch=8, n_taps=3, n_max=2064, code_len=1023,
                     table_rate=1, fs=FS, n_zero=3),
}


def _call(fn, args, shape):
    return fn(args["chunk"], args["offsets"], args["n_samples"],
              args["code_tables"], args["rem_code_phases"],
              args["code_phase_steps"], args["carr_phase_fracs"],
              args["carr_phase_steps"], args["tap_offsets"],
              n_max=shape["n_max"], table_rate=shape["table_rate"])


def k1_work(args, n_taps: int) -> tuple[float, float]:
    """(bytes, flops) the multicorrelator needs on these inputs: each window
    sample read once (the union of the windows), the tables, the per-channel
    parameters and the output; per valid sample 16 float ops of carrier and
    code phase (fma, mod, scale, sincos counted as 2, wipe-off) plus 6 per
    tap (index add and scale, two multiply-adds)."""
    length = args["chunk"].shape[0]
    off = args["offsets"].cpu().numpy().astype(np.int64)
    ns = args["n_samples"].cpu().numpy().astype(np.int64)
    covered = np.zeros(length + 1, np.int64)
    for o, n in zip(off, ns):
        if n > 0:
            covered[max(o, 0)] += 1
            covered[min(o + n, length)] -= 1
    window = int(np.count_nonzero(np.cumsum(covered)[:length]))
    n_ch = off.shape[0]
    nbytes = (window * 8 + args["code_tables"].numel() * 4 + n_ch * 6 * 4
              + n_taps * 4 + n_ch * n_taps * 2 * 4)
    flops = float(ns.sum()) * (16 + 6 * n_taps)
    return float(nbytes), flops


def phase_k1(device, correlator) -> float:
    t0 = time.perf_counter()
    worst = {}
    for name, shape in K1_SHAPES.items():
        args = k1_inputs(device=device, **shape)
        out_k = _call(correlator.batch_epoch_correlate, args, shape)
        out_p = _call(correlator.epoch_correlate_plain, args, shape)
        if device.type == "cuda":
            torch.cuda.synchronize()
        k, p = out_k.double().cpu().numpy(), out_p.double().cpu().numpy()
        abs_err = float(np.abs(k - p).max())
        rel_err = float((np.abs(k - p) / np.maximum(np.abs(p), 1e-30)).max())
        ok = bool(np.allclose(k, p, rtol=RTOL, atol=ATOL)
                  and np.isfinite(k).all())
        zero_ok = True
        if shape.get("n_zero"):
            zero = args["n_samples"].cpu().numpy() == 0
            zero_ok = bool((k[zero] == 0).all())
        _line("K1", t0, shape=name, C=shape["n_ch"], K=shape["n_taps"],
              n_max=shape["n_max"], Lt=shape["code_len"] * shape["table_rate"],
              max_abs_err=f"{abs_err:.3e}", max_rel_err=f"{rel_err:.3e}",
              ok=ok and zero_ok)
        if not (ok and zero_ok):
            raise SystemExit(f"K1 disagrees with its plain version at {name}")
        worst[name] = abs_err
    return worst["a_main_path"]


def _time_ms(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_timing(device, correlator, smi: str) -> dict:
    t0 = time.perf_counter()
    results = {}
    for name in ("a_main_path", "b_c128"):
        shape = K1_SHAPES[name]
        args = k1_inputs(device=device, **shape)
        out = torch.empty((shape["n_ch"], shape["n_taps"], 2),
                          dtype=torch.float32, device=device)
        params = {k: args[k] for k in ("rem_code_phases", "code_phase_steps",
                                       "carr_phase_fracs", "carr_phase_steps")}
        # the raw launch, its arguments packed once (the wrapper's checks and
        # allocation are timed separately as wrapper_us)
        kargs = correlator.kernel_args(
            args["chunk"], args["offsets"], args["n_samples"],
            args["code_tables"], params, args["tap_offsets"], shape["n_max"],
            shape["table_rate"], out)

        def kernel():
            correlator.launch_kernel(kargs)

        def plain():
            _call(correlator.epoch_correlate_plain, args, shape)

        def wrapper():
            _call(correlator.batch_epoch_correlate, args, shape)

        for fn in (plain, kernel, wrapper):
            _time_ms(fn, 50)                           # warm-up
        p1 = _time_ms(plain, 500)
        k1 = _time_ms(kernel, 500)
        k2 = _time_ms(kernel, 500)
        p2 = _time_ms(plain, 500)
        w = _time_ms(wrapper, 500)
        nbytes, flops = k1_work(args, shape["n_taps"])
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        r = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, wrapper_ms=w,
                 bound_ms=max(t_bytes, t_flops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_flops else "operations",
                 bytes=nbytes, flops=flops)
        results[name] = r
        _line("timing", t0, shape=name, kernel_us=f"{r['ms'] * 1e3:.2f}",
              kernel_turns_us=f"{k1 * 1e3:.2f}/{k2 * 1e3:.2f}",
              wrapper_us=f"{w * 1e3:.2f}",
              plain_us=f"{r['plain_ms'] * 1e3:.2f}",
              plain_turns_us=f"{p1 * 1e3:.2f}/{p2 * 1e3:.2f}",
              bound_us=f"{r['bound_ms'] * 1e3:.4f}", bound_by=r["bound_by"],
              bytes=int(nbytes), flops=int(flops), card=f'"{smi}"')
    return results


# --------------------------------------------------------------------- K2 ---
K2_RTOL, K2_ATOL = 1e-4, 1e-4
# float ops of the loop update per channel and step (discriminators, loop
# filters, C/N0, NCO advance; a count of tracking.py's step, rounded up)
K2_UPDATE_FLOPS = 150


def _tensor(a, device):
    return None if a is None else torch.from_numpy(a).to(device)


def k2_case(device, **kw) -> tuple:
    """(cfg, chunk, carry, tables, sec) of the port's open-loop handoff
    (gnss_sdr_tpu_torch.utils.scenario.tracking_handoff_case) on device."""
    from gnss_sdr_tpu_torch.utils import scenario

    c = scenario.tracking_handoff_case(device, **kw)
    return (c["cfg"], _tensor(c["chunk"], device), c["state"],
            _tensor(c["tables"], device), _tensor(c["sec"], device))


def _carry_leaves(state):
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    st = trk.state_to_numpy(state)
    for name in trk.TrackingState._fields:
        v = getattr(st, name)
        if name in ("dll", "pll", "cn0"):
            for sub, x in zip(v._fields, v):
                yield f"{name}.{sub}", x
        else:
            yield name, v


def _tol_ratio(a, b) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 where the two agree."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not a.size:
        return 0.0
    return float((np.abs(a - b) / (K2_ATOL + K2_RTOL * np.abs(b))).max())


def _abs_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


def k2_compare(packed, ref_packed, state, ref_state) -> dict:
    """Hold K2's packed outputs and new carry against the plain version's."""
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    f, i32, lol = trk.unpack_host_outputs(packed.cpu().numpy())
    rf, ri32, rlol = trk.unpack_host_outputs(ref_packed.cpu().numpy())
    bad = []
    if not np.array_equal(i32, ri32):
        bad.append(f"int columns (step, channel, column) "
                   f"{np.argwhere(i32 != ri32)[:3].tolist()}")
    if not np.array_equal(lol, rlol):
        bad.append("loss flag")
    if not np.array_equal(f[..., 8], rf[..., 8]):
        bad.append("valid")
    float_ratio = _tol_ratio(f[..., 2:8], rf[..., 2:8])
    z, rz = f[..., 0] + 1j * f[..., 1], rf[..., 0] + 1j * rf[..., 1]
    dz = np.abs(z - rz)
    prompt_ratio = float((dz / (K2_ATOL + K2_RTOL * np.abs(rz))).max())
    # the largest absolute difference of any compared float: the prompt, the
    # float columns and every float field of the carry
    abs_err = max(float(dz.max()), _abs_err(f[..., 2:8], rf[..., 2:8]))
    for (name, a), (_, b) in zip(_carry_leaves(state),
                                 _carry_leaves(ref_state)):
        if a.dtype.kind in "biu":
            if not np.array_equal(a, b):
                bad.append(f"carry {name}")
        else:
            r = _tol_ratio(a, b)
            float_ratio = max(float_ratio, r)
            abs_err = max(abs_err, _abs_err(a, b))
            if not r <= 1.0:
                bad.append(f"carry {name}")
    if not float_ratio <= 1.0:
        bad.append("float columns")
    if not prompt_ratio <= 1.0:
        bad.append("prompt")
    return dict(max_abs_err=abs_err, prompt_abs_err=float(dz.max()),
                prompt_tol_ratio=prompt_ratio, float_tol_ratio=float_ratio,
                valid=int((f[..., 8] > 0.5).sum()), bad=bad)


def phase_k2_case(name: str, device, cfg, chunk, state, tables, sec) -> dict:
    """K2 (track_chunk_packed on the card) against the eager loop with the
    plain correlator, from the same carry; returns k2_compare's readings."""
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    t0 = time.perf_counter()
    new, packed = trk.track_chunk_packed(cfg, chunk, state, tables, sec)
    ref_state, out = trk.track_chunk(
        cfg, chunk, state, tables, sec,
        correlate=correlator.epoch_correlate_plain)
    ref = trk.pack_host_outputs(out, ref_state.loss_of_lock)
    if device.type == "cuda":
        torch.cuda.synchronize()
    r = k2_compare(packed, ref, new, ref_state)
    # beside the tolerances: whether K2 gave the plain version's very bits
    bitwise = (torch.equal(packed.view(torch.int32), ref.view(torch.int32))
               and torch.equal(tk.pack_carry(new), tk.pack_carry(ref_state)))
    states = np.bincount(state.state.cpu().numpy(), minlength=4).tolist()
    _line("K2", t0, case=name, C=int(tables.shape[0]), steps=cfg.n_steps,
          valid_epochs=r["valid"], start_states=states,
          end_states=np.bincount(new.state.cpu().numpy(),
                                 minlength=4).tolist(),
          max_abs_err=f"{r['max_abs_err']:.3e}",
          prompt_max_abs_err=f"{r['prompt_abs_err']:.3e}",
          prompt_tol_ratio=f"{r['prompt_tol_ratio']:.3e}",
          float_tol_ratio=f"{r['float_tol_ratio']:.3e}",
          bitwise=bitwise, ok=not r["bad"])
    if r["bad"]:
        raise SystemExit(f"K2 disagrees with its plain version at {name}: "
                         f"{r['bad']}")
    return r


def _worst(a: dict | None, b: dict) -> dict:
    """The larger error and tolerance ratio of two cases' readings."""
    keys = ("max_abs_err", "float_tol_ratio", "prompt_tol_ratio")
    return {k: max(b[k], a[k] if a else 0.0) for k in keys}


def phase_k2(device, with_k16: bool) -> dict:
    worst = None
    for name, kw in (("plain", {}), ("extended", dict(extended=True)),
                     ("k16", dict(chunks=16))):
        if name == "k16" and not with_k16:
            continue
        worst = _worst(worst, phase_k2_case(name, device,
                                            *k2_case(device, **kw)))
    return worst


def k2_work(cfg, out, n_ch: int, table_len: int, width: int) -> tuple:
    """(bytes, flops) one K2 launch needs on these inputs, from the plain
    version's outputs: the union of the epoch windows read once, the code
    tables, the carry in and out and the packed outputs; per valid sample
    the multicorrelator's 16 + 6K float ops (k1_work), per valid epoch
    K2_UPDATE_FLOPS."""
    valid = out.valid.cpu().numpy()
    start = out.start_offset.cpu().numpy().astype(np.int64)[valid]
    ns = out.n_samples.cpu().numpy().astype(np.int64)[valid]
    length = cfg.chunk_len + cfg.n_max
    covered = np.zeros(length + 1, np.int64)
    np.add.at(covered, np.clip(start, 0, length), 1)
    np.add.at(covered, np.clip(start + ns, 0, length), -1)
    window = int(np.count_nonzero(np.cumsum(covered)[:length]))
    n_taps = len(cfg.tap_offsets)
    nbytes = (window * 8 + n_ch * table_len * 4 + 2 * n_ch * width * 4
              + cfg.n_steps * n_ch * 13 * 4)
    flops = float(ns.sum()) * (16 + 6 * n_taps) + valid.sum() * K2_UPDATE_FLOPS
    return float(nbytes), float(flops)


def phase_timing_k2(device, smi: str) -> dict:
    """K2 per 100 ms chunk at C=8 and C=128: the raw launch in turns with
    the eager loop on the plain correlator and on K1 (both host-bound: one
    call each per turn)."""
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    results = {}
    for n_ch in (8, 128):
        t0 = time.perf_counter()
        cfg, chunk, state, tables, _ = k2_case(device, n_channels=n_ch)
        carry = tk.pack_carry(state)
        carry_out = torch.empty_like(carry)
        packed = torch.empty((cfg.n_steps, n_ch, tk.PACKED_COLS),
                             dtype=torch.float32, device=device)

        kargs = tk.kernel_args(cfg, chunk, carry, tables, None, carry_out,
                               packed)

        def kernel():
            tk.launch_kernel(kargs)

        def plain():
            st, o = trk.track_chunk(cfg, chunk, state, tables,
                                    correlate=correlator.epoch_correlate_plain)
            trk.pack_host_outputs(o, st.loss_of_lock)

        def eager_k1():
            st, o = trk.track_chunk(cfg, chunk, state, tables)
            trk.pack_host_outputs(o, st.loss_of_lock)

        def wrapper():
            trk.track_chunk_packed(cfg, chunk, state, tables)

        _time_ms(kernel, 3)                               # warm-up
        for fn in (plain, eager_k1, wrapper):
            _time_ms(fn, 1)
        p1 = _time_ms(plain, 1)
        k_a = _time_ms(kernel, 20)
        k_b = _time_ms(kernel, 20)
        p2 = _time_ms(plain, 1)
        e1 = _time_ms(eager_k1, 1)
        e2 = _time_ms(eager_k1, 1)
        w = _time_ms(wrapper, 20)
        _, out = trk.track_chunk(cfg, chunk, state, tables,
                                 correlate=correlator.epoch_correlate_plain)
        nbytes, flops = k2_work(cfg, out, n_ch, tables.shape[1],
                                carry.shape[1])
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        r = dict(ms=(k_a + k_b) / 2, plain_ms=(p1 + p2) / 2,
                 eager_k1_ms=(e1 + e2) / 2, wrapper_ms=w,
                 bound_ms=max(t_bytes, t_flops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_flops else "operations")
        results[n_ch] = r
        _line("timing", t0, shape=f"k2_c{n_ch}", steps=cfg.n_steps,
              kernel_ms=f"{r['ms']:.4f}",
              kernel_turns_ms=f"{k_a:.4f}/{k_b:.4f}",
              wrapper_ms=f"{w:.4f}",
              eager_plain_ms=f"{r['plain_ms']:.3f}",
              eager_plain_turns_ms=f"{p1:.3f}/{p2:.3f}",
              eager_k1_ms=f"{r['eager_k1_ms']:.3f}",
              bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
              bytes=int(nbytes), flops=int(flops), card=f'"{smi}"')
    return results


# ------------------------------------------------------------- main path ---
def _timed(rx, names, acc: dict) -> None:
    """Accumulate the host seconds spent in each named receiver method (an
    instance attribute shadowing the method; the receiver is not changed)."""
    for name in names:
        fn = getattr(rx, name)
        acc[name] = 0.0

        def wrapper(*a, _fn=fn, _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc[_name] += time.perf_counter() - t
        setattr(rx, name, wrapper)


def phase_main(device, duration_s: float, check_fix: bool) -> dict:
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    sc = scenario.build_gps_l1_scenario(duration_s=duration_s, n_sats=6,
                                        cn0_dbhz=47.0, fs=FS)
    x = sc.generate(seed=123)
    _line("main", t0, step="generate", samples=len(x), prns=list(sc.prns))

    t0 = time.perf_counter()
    cfg = ReceiverConfig(signal="1C", fs=FS, n_channels=8,
                         prns=tuple(sc.prns), chunk_ms=100,
                         pvt_apply_tropo=False, pvt_apply_iono=False)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    rx = Receiver(cfg, device=device)
    # where the wall time goes: upload, acquisition, enqueueing the tracking
    # dispatch, waiting for its packed outputs (finish minus consume), the
    # host telemetry consume, observables + PVT
    spent: dict = {}
    _timed(rx, ("_upload", "_run_acquisition", "_dispatch_tracking",
                "_finish_tracking", "_consume_tracking", "_run_observables"),
           spent)
    correlator.launches = 0
    tk.launches = 0
    rx.run_source(ArraySignalSource(x, FS))
    if device.type == "cuda":
        torch.cuda.synchronize()
    k1, k2 = correlator.launches, tk.launches
    wall = time.perf_counter() - t0
    tracked = sorted(rx.tracked_prns())
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else "not measured")
    _line("main", t0, step="receiver", wall_s=f"{wall:.3f}",
          realtime_x=f"{duration_s / wall:.3f}", tracked=tracked,
          scan_steps=rx.scan_steps, dispatches=rx.tracking_dispatches,
          k2_launches=k2, k1_launches=k1, max_memory_allocated=peak)
    wait = spent["_finish_tracking"] - spent["_consume_tracking"]
    n_disp = max(rx.tracking_dispatches, 1)
    _line("main", t0, step="breakdown",
          upload_s=f"{spent['_upload']:.3f}",
          acquisition_s=f"{spent['_run_acquisition']:.3f}",
          tracking_enqueue_s=f"{spent['_dispatch_tracking']:.3f}",
          tracking_wait_s=f"{wait:.3f}",
          telemetry_consume_s=f"{spent['_consume_tracking']:.3f}",
          observables_pvt_s=f"{spent['_run_observables']:.3f}",
          enqueue_us_per_dispatch=f"{spent['_dispatch_tracking'] / n_disp * 1e6:.1f}",
          enqueue_us_per_step=f"{spent['_dispatch_tracking'] / max(rx.scan_steps, 1) * 1e6:.3f}")
    if tracked != sorted(sc.prns):
        raise SystemExit(f"tracked {tracked}, expected {sorted(sc.prns)}")
    if device.type == "cuda" and not (k2 == rx.tracking_dispatches > 0
                                      and k1 == 0):
        raise SystemExit(f"K2 launches {k2} != dispatches "
                         f"{rx.tracking_dispatches}, or K1 launched {k1} "
                         f"times on the main path")
    if check_fix:
        ephs = rx.ephemerides
        bad = [prn for (_, prn), e in ephs.items()
               if abs(e.sqrt_a - sc.ephemerides[prn].sqrt_a) > 2.0 ** -19
               or e.toe != sc.ephemerides[prn].toe]
        lat, lon, _ = sc.rcv_llh
        if len(rx.fixes) < 5:
            raise SystemExit(f"only {len(rx.fixes)} fixes")
        enu = np.stack([geodesy.ecef_to_enu(f.pos_ecef - sc.rcv_ecef, lat, lon)
                        for f in rx.fixes[-10:]]).mean(axis=0)
        err_2d, err_3d = float(np.hypot(enu[0], enu[1])), float(np.linalg.norm(enu))
        ttff = rx.fixes[0].tow_s - sc.t0_gps
        _line("main", t0, step="checks", ephemerides=len(ephs),
              eph_mismatch=bad, fixes=len(rx.fixes), err_2d_m=f"{err_2d:.3f}",
              err_3d_m=f"{err_3d:.3f}", ttff_s=f"{ttff:.2f}")
        if len(ephs) < 4 or bad:
            raise SystemExit(f"ephemerides: {len(ephs)} decoded, bad {bad}")
        if not (err_2d < 2.0 and err_3d < 5.0):
            raise SystemExit(f"fix error 2D {err_2d:.2f} m / 3D {err_3d:.2f} m")
    return dict(k1_launches=k1, k2_launches=k2, wall_s=wall, rx=rx, x=x,
                prns=sorted(sc.prns), sc=sc)


def phase_stream(device, x: np.ndarray, prns: list, duration_s: float) -> None:
    """The streaming configuration of conf/gps_l1_realtime_tpu.conf:21-23
    (dispatch_chunks=16, upload_bits=4, pipeline_depth=4) on the first
    ``duration_s`` of the main scenario: every satellite tracked."""
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    t0 = time.perf_counter()
    cfg = ReceiverConfig(signal="1C", fs=FS, n_channels=8, prns=tuple(prns),
                         chunk_ms=100, dispatch_chunks=16, upload_bits=4,
                         pipeline_depth=4, pvt_apply_tropo=False,
                         pvt_apply_iono=False)
    rx = Receiver(cfg, device=device)
    correlator.launches = 0
    tk.launches = 0
    rx.run_source(ArraySignalSource(x[: int(duration_s * FS)], FS))
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracked = sorted(rx.tracked_prns())
    _line("stream", t0, dispatch_chunks=16, upload_bits=4, pipeline_depth=4,
          wall_s=f"{wall:.3f}", realtime_x=f"{duration_s / wall:.3f}",
          tracked=tracked, dispatches=rx.tracking_dispatches,
          scan_steps=rx.scan_steps, k2_launches=tk.launches,
          k1_launches=correlator.launches, fixes=len(rx.fixes))
    if tracked != sorted(prns):
        raise SystemExit(f"streaming run tracked {tracked}, expected "
                         f"{sorted(prns)}")
    if not (tk.launches == rx.tracking_dispatches > 0
            and correlator.launches == 0):
        raise SystemExit("streaming run: K2 launches != dispatches")


def _final_carry_case(rx, x: np.ndarray) -> tuple:
    """(cfg, chunk, carry, tables, None): the receiver's own dispatch on its
    final carry (as a TrackingState), over the stream's first chunk as the
    receiver uploads it."""
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    g = rx.groups[0]
    cfg = g.trk_cfg
    return (cfg, rx._upload(x[: cfg.chunk_len + cfg.n_max]),
            trk.as_state(g.trk_state), g._tables_dev, None)


def _enqueue_us(fn, n: int) -> float:
    """Host microseconds per call to enqueue ``n`` calls of ``fn`` (the
    device work is waited for after the clock stops)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_profile(rx, x: np.ndarray, n_chunks: int = 20) -> None:
    """Device view of the main path's tracking: ``n_chunks`` dispatches of
    the receiver's own call on its final carry, timed by the host clock,
    then once more under torch.profiler for the device time of every
    kernel and copy. Prints host ms per chunk, device ms per chunk, the
    device's busy share, device operations per chunk and K2's share of the
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    t0 = time.perf_counter()
    cfg, chunk_dev, state, tables, _ = _final_carry_case(rx, x)
    carry = tk.pack_carry(state)

    def run():
        return trk.track_chunk_packed(cfg, chunk_dev, carry, tables)[1]

    def run_unpacked():
        return trk.track_chunk_packed(cfg, chunk_dev, state, tables)[1]

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_chunks):
        out = run()
    out.cpu()
    host_ms = (time.perf_counter() - t1) / n_chunks * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_chunks):
            out = run()
        out.cpu()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise SystemExit("the profiler saw no device activity")
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    k2 = [e for e in dev if "track_chunk_kernel" in e.name]
    k2_us = sum(e.time_range.elapsed_us() for e in k2)
    dev_ms = dev_us / n_chunks / 1e3
    # enqueueing one dispatch, packed carry against packed / unpacked
    # around the launch, in turns (unpacked, packed, packed, unpacked)
    turns = [_enqueue_us(fn, 50) for fn in (run_unpacked, run, run,
                                            run_unpacked)]
    _line("profile", t0, channels_tracking=int(state.active.sum()),
          host_ms_per_chunk=f"{host_ms:.3f}",
          device_ms_per_chunk=f"{dev_ms:.3f}",
          device_busy_share=f"{dev_ms / host_ms:.4f}",
          device_ops_per_chunk=f"{len(dev) / n_chunks:.1f}",
          k2_launches=len(k2), k2_share_of_device=f"{k2_us / dev_us:.4f}",
          k2_us_per_launch=f"{k2_us / max(len(k2), 1):.3f}",
          enqueue_us_per_dispatch_packed=f"{(turns[1] + turns[2]) / 2:.1f}",
          enqueue_us_per_dispatch_unpacked=f"{(turns[0] + turns[3]) / 2:.1f}",
          enqueue_turns_us="/".join(f"{t:.1f}" for t in turns))


# -------------------------------------------------------------------- CLI ---
ROOT = pathlib.Path(__file__).resolve().parent


def _write_ishort(path, x: np.ndarray) -> None:
    """Complex samples as interleaved int16 I/Q at an rms of ~1000."""
    scale = 1000.0 / np.sqrt(np.mean(np.abs(x[:1_000_000]) ** 2))
    raw = np.empty(2 * len(x), np.int16)
    raw[0::2] = np.round(x.real * scale)
    raw[1::2] = np.round(x.imag * scale)
    raw.tofile(path)


def _conf_from_shipped(capture, keys: dict) -> str:
    """conf/gps_l1_file.conf with its capture path replaced and ``keys``
    appended (a later line wins)."""
    lines = []
    for ln in (ROOT / "conf" / "gps_l1_file.conf").read_text().splitlines():
        if ln.startswith("SignalSource.filename="):
            ln = f"SignalSource.filename={capture}"
        lines.append(ln)
    lines += [f"{k}={v}" for k, v in keys.items()]
    return "\n".join(lines) + "\n"


def _run_cli(conf_path, platform: str, *extra) -> tuple[str, str]:
    """``python3 -m gnss_sdr_tpu_torch -c conf`` from the checkout; fails
    the phase on a non-zero exit. Returns (stdout, stderr)."""
    out = subprocess.run(
        [sys.executable, "-m", "gnss_sdr_tpu_torch", "-c", str(conf_path),
         "--platform", platform, *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"the CLI exited {out.returncode}")
    return out.stdout, out.stderr


def _summary(stdout: str) -> dict:
    """The CLI's summary lines as numbers."""
    got = {}
    m = re.search(r"tracked PRNs: \[([\d, ]*)\]; tracking_dispatches=(\d+) "
                  r"tracking_kernel_launches=(\d+) "
                  r"multicorrelator_launches=(\d+)", stdout)
    if m is None:
        raise SystemExit(f"no summary line in the CLI's output: {stdout!r}")
    got["tracked"] = [int(v) for v in m.group(1).split(",") if v.strip()]
    got["dispatches"], got["k2"], got["k1"] = map(int, m.groups()[1:])
    m = re.search(r"last fix: lat=([-\d.]+) lon=([-\d.]+) h=([-\d.]+) m",
                  stdout)
    if m is not None:
        got["fix_llh"] = tuple(map(float, m.groups()))
    return got


def phase_cli(device, main_run: dict, cond_s: float) -> int:
    """The CLI on the main phase's capture (checks above, phase 8), then a
    conditioned run of ``cond_s`` seconds at 4 MSps. Returns the CLI's K2
    launches."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy
    from gnss_sdr_tpu_torch.receiver.pvt.rinex import (RinexNavReader,
                                                       RinexNavWriter,
                                                       RinexObsReader)
    from gnss_sdr_tpu_torch.utils import scenario

    platform = "cuda" if device.type == "cuda" else "cpu"
    sc, x, rx = main_run["sc"], main_run["x"], main_run["rx"]
    prns = main_run["prns"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        _write_ishort(tmp / "capture.ishort", x)
        conf = tmp / "rx.conf"
        conf.write_text(_conf_from_shipped(tmp / "capture.ishort", {
            "SignalSource.sampling_frequency": 2000000,
            "PVT.nmea_dump_filename": tmp / "out.nmea",
            "PVT.kml_filename": tmp / "out.kml",
            "PVT.rinex_obs_filename": tmp / "out.obs",
            "PVT.rinex_nav_filename": tmp / "out.nav",
            "PVT.trop_model": "OFF", "PVT.iono_model": "OFF"}))
        t1 = time.perf_counter()
        stdout, stderr = _run_cli(conf, platform)
        cli_s = time.perf_counter() - t1
        got = _summary(stdout)
        nmea = (tmp / "out.nmea").read_text()
        obs_prns = sorted({o["prn"] for _, ep in
                           RinexObsReader(tmp / "out.obs").read_epochs()
                           for o in ep})
        nav = RinexNavReader(tmp / "out.nav").read()
        # the main phase's ephemerides through the same writer and reader
        w = RinexNavWriter(tmp / "main.nav")
        for (sys_, _), e in rx.ephemerides.items():
            w.write_ephemeris(e, system=sys_)
        w.close()
        main_nav = RinexNavReader(tmp / "main.nav").read()
        eph_equal = (sorted(nav) == sorted(main_nav) and all(
            dataclasses.asdict(nav[k]) == dataclasses.asdict(main_nav[k])
            for k in nav))
        checks = dict(device_line=f"device: {platform}" in stderr,
                      gga=nmea.count("$GPGGA"), obs_prns=obs_prns,
                      nav_ephemerides=len(nav), eph_equal_main=eph_equal)
        err = {}
        if "fix_llh" in got:
            lat, lon, h = got["fix_llh"]
            pos = geodesy.geodetic_to_ecef(np.deg2rad(lat), np.deg2rad(lon), h)
            enu = geodesy.ecef_to_enu(pos - sc.rcv_ecef, *sc.rcv_llh[:2])
            err = dict(err_2d_m=float(np.hypot(enu[0], enu[1])),
                       err_3d_m=float(np.linalg.norm(enu)))
        _line("cli", t0, run="capture", cli_seconds=f"{cli_s:.3f}",
              tracked=got["tracked"], tracking_dispatches=got["dispatches"],
              k2_launches=got["k2"], k1_launches=got["k1"],
              **{k: f"{v:.3f}" for k, v in err.items()}, **checks)
        # the CPU rehearsal's 3 s decode no navigation data: no observables
        full = device.type == "cuda"
        bad = [name for name, ok in (
            ("device line", checks["device_line"]),
            ("tracked PRNs", got["tracked"] == prns),
            ("RINEX obs PRNs", not full or obs_prns == prns),
            ("K2 launches", not full or got["k2"] == got["dispatches"] > 0),
            ("K1 launches", got["k1"] == 0),
            ("fix", not full or (err and err["err_2d_m"] < 2.0
                                 and err["err_3d_m"] < 5.0)),
            ("GGA sentences", not full or checks["gga"] > 0),
            ("RINEX nav", not full or (len(nav) == len(prns) and eph_equal)))
            if not ok]
        if bad:
            raise SystemExit(f"CLI run failed its checks: {bad}")

        # the shipped rates: 4 MSps conditioned to 2 MSps
        t0 = time.perf_counter()
        sc4 = scenario.build_gps_l1_scenario(duration_s=cond_s, n_sats=6,
                                             cn0_dbhz=47.0, fs=4.0e6)
        _write_ishort(tmp / "capture4.ishort", sc4.generate(seed=123))
        conf4 = tmp / "rx4.conf"
        conf4.write_text(_conf_from_shipped(tmp / "capture4.ishort", {}))
        t1 = time.perf_counter()
        stdout, stderr = _run_cli(conf4, platform, "--max_chunks",
                                  str(int(cond_s * 10)))
        cli_s = time.perf_counter() - t1
        got4 = _summary(stdout)
        _line("cli", t0, run="conditioned_4msps", cli_seconds=f"{cli_s:.3f}",
              tracked=got4["tracked"], tracking_dispatches=got4["dispatches"],
              k2_launches=got4["k2"],
              conditioning="conditioning 4000000 sps -> 2000000 sps" in stderr)
        if got4["tracked"] != sorted(sc4.prns) or (
                device.type == "cuda"
                and not got4["k2"] == got4["dispatches"] > 0):
            raise SystemExit(f"conditioned CLI run tracked {got4['tracked']}, "
                             f"expected {sorted(sc4.prns)}")
    return got["k2"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse phases 3, 4, 6 and 8 on the CPU (plain "
                         "versions)")
    args = ap.parse_args(argv)

    from gnss_sdr_tpu_torch.ops import correlator

    if args.cpu:
        device = torch.device("cpu")
        phase_k1(device, correlator)
        phase_k2(device, with_k16=False)
        phase_cli(device, phase_main(device, 3.0, check_fix=False), 0.5)
        return 0

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a card", file=sys.stderr)
        return 1
    # the plain versions are the references: full float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    _line("device", t0, name=f'"{kind}"', count=torch.cuda.device_count(),
          smi=f'"{smi}"', torch=torch.__version__, cuda=torch.version.cuda)

    from gnss_sdr_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    built = cuda_build.build_many(["correlator", "tracking"])
    for name, info in built.items():
        for ln in info["report"].splitlines():
            if "ptxas" in ln or "error" in ln.lower():
                print(f"[build] {name}: {ln.strip()}")
        _line("build", t0, kernel=name, library=info["path"].name,
              nvcc_seconds=f"{info['seconds']:.3f}")

    correlator.launches = 0
    k1_err = phase_k1(device, correlator)
    k2_err = phase_k2(device, with_k16=True)
    timing = phase_timing(device, correlator, smi)
    timing_k2 = phase_timing_k2(device, smi)
    k1_own = correlator.launches
    main_run = phase_main(device, 28.0, check_fix=True)
    rx, x = main_run["rx"], main_run["x"]
    k2_err = _worst(k2_err, phase_k2_case("final_carry", device,
                                          *_final_carry_case(rx, x)))
    phase_stream(device, x, main_run["prns"], 12.0)
    phase_profile(rx, x)
    cli_k2 = phase_cli(device, main_run, 2.0)

    a, k2c8 = timing["a_main_path"], timing_k2[8]
    record = {"kernels": [{
        "name": "epoch_multicorrelator",
        "route": "cuda",
        "source": "gnss_sdr_tpu_torch/csrc/correlator.cu",
        "replaces": "gnss_sdr_tpu/ops/correlator_pallas.py:70",
        "launches": k1_own,
        "main_path_launches": main_run["k1_launches"],
        "max_abs_err": k1_err,
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": None,
    }, {
        "name": "tracking_chunk",
        "route": "cuda",
        "source": "gnss_sdr_tpu_torch/csrc/tracking.cu",
        "replaces": "gnss_sdr_tpu/receiver/tracking.py:432",
        "launches": main_run["k2_launches"],
        "cli_launches": cli_k2,
        "max_abs_err": k2_err["max_abs_err"],
        "float_tol_ratio": k2_err["float_tol_ratio"],
        "prompt_tol_ratio": k2_err["prompt_tol_ratio"],
        "ms": k2c8["ms"],
        "plain_ms": k2c8["plain_ms"],
        "bound_ms": k2c8["bound_ms"],
        "bound_by": k2c8["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(record))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
