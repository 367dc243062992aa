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
            chunk: the open-loop handoff of 5 GPS L1 satellites on 6
            channels, plain and with extended integration + a secondary code
            (102 steps, pull-in reaching WIDE at step 100), and a dispatch of
            16 chunks (1602 steps); Galileo E1 at 4 MSps (27 steps, n_max
            16064, the tiled window): (e) E1-B with VEML taps, (f) E1-C pilot
            tracking with the E1-B data prompt, alone and with extended
            integration + the CS25 wipe, (g) one two-group dispatch (GPS at
            4 MSps + E1 pilot on one shared chunk, one launch per group);
            the wideband shapes (102 steps, 10,230-entry tables, three
            4096-sample tiles per epoch): (h) GPS L5I at 11 MSps, C=4, (i)
            L5Q pilot tracking with the NH10 wipe after the extension, (j)
            Galileo E5a-I at 12 MSps, C=4, with the CS20 wipe, (k) E5a-Q
            pilot tracking; (l) GPS L2C at 2 MSps (20 ms epochs of 40,000
            samples, n_max 40,064, 7 steps a chunk), C=5, over two
            consecutive dispatches, the second from the carry K2 wrote;
            (m) BeiDou B1I at 4 MSps with the NH20 wipe after the
            extension; (n) GLONASS L1 C/A at 8 MSps over two consecutive
            dispatches, each channel at its FDMA slot's IF (slots -7, 0,
            +6, +3, -2: |IF| up to 3.94 MHz); (o) GLONASS L2 C/A at 6 MSps
            (slots +6, -7, 0, -4, +2); (p) BeiDou B3I at 12 MSps with the
            NH20 wipe after the extension; after the main, hybrid, l5, e5a,
            dynamic, l2c, b1i, glo_l1, glo_l2 and b3i phases, the
            receivers' final carries (channels in NARROW_TRACK). Packed
            int32 columns, valid, the loss flag and the carry's int / bool
            fields equal; float columns and float carry fields within rtol
            1e-4 / atol 1e-4; the prompt
            within |dz| <= 1e-4 |z| + 1e-4 (tests/test_torch_tracking.py's
            tolerances); each case runs at the cluster size the wrapper
            picks. Then GPS L1, the E1 pilot and the E5a pilot handoffs at
            every cluster size m = 1, 2, 4, 8, forced: bit for bit the
            plain version's packed rows and carry, or the phase fails; the
            same at the L2C shape (C=5), GLONASS L1 (n) and B3I with NH20
            (p). The Kalman carrier loop (K2's KF variants), each case bit
            for bit (max abs error 0) or the phase fails: (q) GPS L1 at
            C=8 over two 200 ms dispatches, the second from the carry K2
            wrote (kf_p / kf_acc included), and at every forced m; (r) GPS
            L5I at C=4; after the kf phase, (s) its receiver's final carry
            (the dynamic shape, C=6).
5. timing   K1 and its plain version at shapes (a) and (b), CUDA events over
            500 launches each after a warm-up, in turns (plain, kernel,
            kernel, plain), beside the bound computed from the shapes; K2
            per 100 ms chunk at the GPS shape (C=8 and C=128), the E1
            pilot shape (C=6 and C=128), GPS L5 (C=4 and C=128) and the
            E5a pilot shape (C=4 and C=128), GPS L5 with the L5Q pilot
            (C=6), E5a data-only (C=4), GPS L2C (C=5 and C=128), BeiDou
            B1I (C=4 and C=128), GPS L1 at the dynamic receiver's C=6,
            GLONASS L1 (C=5 and C=128), GLONASS L2 (C=4) and BeiDou B3I
            (C=4 and C=128), and the KF variant at GPS L1 C=8 and C=128
            past pull-in (the KF updating every epoch), in turns with the
            non-KF variant on the same carry and with the eager loop:
            at the chosen cluster size and
            at m=1 in turns, then every m, and the step split into its
            parts (ring fill with the step's barriers, accumulate, reduce,
            scalar update) by the timing builds that leave parts out, in
            turns with the eager loop on the plain correlator (and, for
            single-component tables, the eager loop on K1), beside K2's
            bound. With --k2-baseline DIR, DIR's K2 (another checkout,
            the parent commit's say) at the same shapes before and after.
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
9. hybrid   the in-process hybrid receiver (6 GPS + 6 Galileo channels) on
            tests/test_e2e_hybrid.py's 26 s, 4 MSps, 4 + 4 satellite
            scenario with the E1-C pilot in the signal: each system tracked,
            ephemerides, a mixed fix within budget with |ISB| < 1 us, one K2
            launch per group dispatch; the host seconds of each stage. Then
            the shipped conf/hybrid_gps_galileo.conf through the CLI on that
            capture (phase_cli_hybrid).
10. l5, e5a the in-process GPS L5I and Galileo E5a receivers (4 channels)
            on tests/test_e2e_l5.py's and tests/test_e2e_e5a.py's scenarios
            (30 s at 11 MSps, seed 77; ~47 s at 12 MSps, seed 87; 4
            satellites at 50 dB-Hz), generated with the pilot component,
            the signal sum on the card: all satellites tracked, >= 4
            ephemerides equal to the truth, the last 5 fixes within 2D < 2 m
            / 3D < 5 m, one K2 launch per dispatch and no K1 launch, the
            host seconds of each stage; K2 on the final carry; then the
            shipped conf/gps_l5.conf (L5Q pilot tracking) and
            conf/galileo_e5a.conf (noncoherent I/Q CAF acquisition) through
            the CLI on that capture (phase_cli_wideband).
11. dynamic tests/test_e2e_dynamic.py's moving receiver ((12, -5, 0) m/s
            ENU, 28 s of 6 GPS L1 C/A satellites at 2 MSps, 47 dB-Hz, seed
            41, 6 channels): position RMSE < 10 m, velocity RMSE < 5 m/s,
            the last 5 fixes' speed within 2 m/s, the motion traversed
            within 25 % / 5 m; K2 on the final carry.
12. l2c     tests/test_e2e_l2c.py's GPS L2C scenario (5 satellites, 58 s
            at 2 MSps, 45 dB-Hz, seed 77, 5 channels, its loop
            bandwidths): all tracked, >= 5 ephemerides, the last 20 fixes
            within 2D < 10 m / 3D < 20 m; K2 on the final carry; the
            shipped conf/gps_l2c.conf through the CLI on the first 8 s.
13. b1i     tests/test_e2e_beidou.py's BeiDou B1I scenario (4 MEO / IGSO
            satellites, 30 s at 4 MSps, 48 dB-Hz, seed 91): all tracked,
            >= 4 ephemerides, the last 5 fixes within 2D < 2 m / 3D < 5 m;
            K2 on the final carry; conf/beidou_b1i.conf through the CLI on
            the first 6 s.
14. glo_l1, glo_l2
            tests/test_e2e_glonass.py's and tests/test_e2e_glonass_l2.py's
            GLONASS scenarios (5 satellites at 8 MSps, seed 97; 4 at 6
            MSps, seed 96; 48 dB-Hz, the scenario's own duration; each
            satellite at its FDMA slot's IF), 5 / 4 channels, carrier
            smoothing 100: all tracked, >= 5 / 4 GNAV ephemerides (tb
            exact, position within 1 m, velocity within 1e-2 m/s), >= 10
            fixes whose last 20 average within 2D < 10 m / 3D < 20 m, the
            L1 receiver's last PDOP < 6; K2 on the final carry; the shipped
            conf/glonass_l1.conf and conf/glonass_l2.conf through the CLI on
            4 s of 3 / 2 of the scenario's satellites at the confs' 9 / 6
            MSps (GLO_CLI: a PRN's antipodal twin shares its slot and code,
            and the confs search all 24 PRNs).
15. b3i     tests/test_e2e_beidou_b3.py's BeiDou B3I scenario (4 MEO /
            IGSO satellites, 30 s at 12 MSps, 48 dB-Hz, seed 88), 4
            channels: all tracked, >= 4 ephemerides (sqrt_a within 1e-3,
            toe exact), >= 5 fixes whose last 10 average within 2D < 2 m /
            3D < 5 m; K2 on the final carry; conf/beidou_b3i.conf through
            the CLI on the first 4 s.
16. kf      the Kalman carrier loop: tests/test_tracking.py's Doppler ramp
            (PRN 5, -300 Hz, 60 Hz/s, 1.5 s at 2.5 MSps) through K2's KF
            build, one dispatch per 50 ms chunk: no loss of lock, the
            final carrier within 5 Hz, the rate state within 20 Hz/s of
            60, carrier lock > 0.85; the dynamic phase's receiver with
            carrier_kf on its capture: every satellite tracked, >= 4
            ephemerides, the dynamic budget, one KF launch per dispatch;
            conf/gps_l1_file.conf with GPS_L1_CA_KF_Tracking through the
            CLI on 8 s of that capture.
17. sbas    tests/test_e2e_sbas.py's scenario (5 GPS satellites with
            broadcast clock errors and SBAS PRN 123 carrying the MT1 mask
            and MT25 corrections, 30 s at 2 MSps, seed 23), the receiver
            with the SBAS corrections off and on, its checks: PRN 123
            tracked, >= 3 messages, the mask, every MT25 daf0 within 2^-31,
            the last 40 fixes' 3D error e_off > 4 m, e_on < 3.5 m, e_on <
            e_off / 3.
18. rtk     tests/test_e2e_rtk.py: the receiver (K2) on its 42 s capture
            (the multisource L1 scenario, 6 satellites, 47 dB-Hz, 2 MSps,
            seed 101), then RtkEngine(sigma_pr_m=2.5, mode="kinematic")
            on its observables against a synthetic base 3 km east (1005 +
            1019, an MSM7 epoch per 25th observable epoch, ambiguities and
            noise from default_rng(71)): >= 60 float epochs, the last 20
            float baselines' mean ENU error < 2 m, >= 3 fixed epochs, the
            median of the last 3 fixes < 2 m, the receiver phase's double
            differences at observable epochs 600 / 1000 / 1400 integer
            (>= 12 checked, mean fractional part < 0.15, worst < 0.45
            cycles); with the seconds of each step.
19. cli_rtk conf/rtk_rover_ntrip.conf through the CLI on that capture as
            ishort (capture path and rate replaced, the atmosphere models
            off, the base at a caster thread on 127.0.0.1 that checks the
            mountpoint BASE1 and the conf's Basic credentials, then streams
            1005 + 1019 and the base's last 20 MSM7 epochs): the request
            seen, the stream delivered, the RTK rover mode logged, RTK
            solutions, exit 0, the mean of the last 10 fixes (its GGA
            sentences) within 2D < 2 m / 3D < 5 m.
            Each of phases 11-19 launches K2 once per tracking dispatch
            and K1 never. The CPU rehearsal runs 3 s of each (and of kf
            and sbas; 4 s of rtk, with its CLI run) without the checks or
            the other CLI runs (the L2C conf's 32-PRN,
            321-bin search of 80,000-sample windows is a card's work).
20. cli_supl  conf/gps_l1_supl.conf (assisted acquisition) through the CLI
            on the main capture's first 14 s, its SUPL server replaced by the
            port's QA SuplServer on 127.0.0.1 (port 0) serving the
            scenario's ephemerides, an almanac, the reference location /
            time and Doppler hints; then with SUPL off: the server's three
            sessions, every ephemeris and hint applied, every satellite
            tracked, the first fix earlier than without SUPL (run after
            cli, on its capture).
21. conditioning  pulse blanking, the notch, the beamformer (4
            elements), freq_translate and direct_resample on the card
            against the same functions on the CPU (100 ms of a GPS L1
            capture with the CW jammer, pulses): the worst error within
            1e-4 max|y| + 1e-5, the notch's bins and the blanked segments
            equal, each op's ms per 100 ms of samples.
22. cli_notch conf/gps_l1_notch.conf (8 channels, 2 MSps) through the CLI
            on tests/test_input_filter_chain.py's jammed scenario (4 s),
            with the notch and with Pass_Through: >= 4 satellites tracked
            with it and more than without; the filter's host seconds.
23. cli_labsat3 conf/labsat3.conf through the CLI on a 5 s LabSat 3 file
            (4-bit, 16.368 MSps, ~41 MB, deleted after the run), decimated
            8:1 on the card: every satellite tracked.
24. front_end_cal  tests/test_front_end_cal.py's 3 ppm capture through
            run_front_end_cal on the card: the 5 satellites found, the
            offset within 200 Hz / 0.15 ppm.
25. sources one capture written as SPIR int1, SPIR GSS6450, a raw
            4-element array, 2-bit packed complex and NSR files, sent as UDP
            datagrams and from a local rtl_tcp server, read back through the
            port's sources equal to the numpy decoders; a UHD conf with the
            mock driver feeding the receiver for 2.8 s: every satellite
            tracked.
            Each CLI run of phases 20-25 launches K2 once per tracking
            dispatch and K1 never; the CPU rehearsal runs them short and
            without their checks.
26. tcp     the main capture's first 3 s on a GPS L1 C/A group with
            tcp_connector=True, a LoopFilterPeer thread per channel on
            127.0.0.1 (run after cli_supl): every satellite tracking, its
            last carrier within 5 Hz of the truth Doppler, C/N0 > 40, no
            peer error; no K2 launch (the loops close on the host) and K1
            once per round of the engine (each round correlates the next
            epoch of every channel in one launch, downloading only the
            taps), the first round's launch held against K1's plain
            version on the same inputs; the engine's seconds in the
            correlations against those in the exchanges with the peers.
27. dumps   the main capture's first 14 s with dump_dir set (warm-started
            with the main run's ephemerides; the first observable waits for
            a subframe's TOW, 12.1 s into this capture): the four npz dumps
            read back with utils/dump_tools, each PRN's last tracking rows
            equal to the receiver's channel records, one PVT row per fix.
28. e1_8ms  the hybrid capture through the hybrid phase's E1 group alone
            with acq_variant="e1_8ms" (run after cli_hybrid): the hybrid
            phase's E1 PRNs acquired and tracked; pcps_8ms_search, cccwsr_search and quicksync_search on
            the card against the CPU: peak cell equal, CFAR within rtol
            1e-3.
29. ms_dual_band  tests/test_e2e_multisource.py's dual-band run: GPS L1 at
            2 MSps and GPS L5 at 12 MSps (7 satellites each, 50 dB-Hz, 42 s
            from T0 352800.08, seeds 101 / 102) as two branches of the
            MultiSourceReceiver, with that test's PppEngine on the merged
            observables, and all its checks (tracking, the shared
            ephemerides, the merged fix, PPP's float and the wide-lane
            integers against the truth geometry); K2 on each branch's final
            carry; then cli_multisource: the captures' first 4 s as two
            ishort files through a two-source conf by the CLI, both branches
            dispatching and tracking.
30. ms_gps_glonass  tests/test_e2e_multisource.py's GPS L1 (6 satellites,
            2 MSps, seed 103) + GLONASS L1 (4 satellites, 8 MSps, t0_day
            7200.08, seed 104) run: both tracked, a merged G + R fix within
            2 m / 5 m with >= 8 satellites; K2 on each branch's final carry.
31. nonlinear_kf  the cubature and unscented filter banks (128 channels) on
            the card against the CPU within rtol 1e-5.
            Each branch of phases 29-30 launches K2 once per tracking
            dispatch (counted per branch) and K1 never. Each capture is
            generated just before its phase and freed after it. The CPU
            rehearsal runs 1-3 s of each, without their checks.

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
# float ops of one Kalman carrier update per channel (ops/kalman.py: the
# measurement variance with its powf, three 3x3 products of 45 each, the
# gain and the state estimates; a count, rounded up)
K2_KF_FLOPS = 185


def _tensor(a, device):
    return None if a is None else torch.from_numpy(a).to(device)


def k2_case(device, **kw) -> tuple:
    """(cfg, chunk, carry, tables, sec) of the port's open-loop handoff
    (gnss_sdr_tpu_torch.utils.scenario.tracking_handoff_case) on device."""
    from gnss_sdr_tpu_torch.utils import scenario

    c = scenario.tracking_handoff_case(device, **kw)
    return (c["cfg"], _tensor(c["chunk"], device), c["state"],
            _tensor(c["tables"], device), _tensor(c["sec"], device))


def k2_two_group_case(device) -> dict:
    """One hybrid dispatch: GPS L1 C/A at 4 MSps (n_max 4064) and Galileo
    E1 with pilot tracking (n_max 16064) on one shared chunk (the two
    handoff cases' signals summed), each group on its slab."""
    g = k2_case(device, signal="1C", fs=4.0e6)
    e = k2_case(device, signal="1B", pilot=True, seed=12)
    chunk = e[1].clone()
    chunk[: g[1].shape[0]] += g[1]
    cfgs = (g[0], e[0])
    return dict(cfgs=cfgs, chunk=chunk, states=(g[2], e[2]),
                tables=(g[3], e[3]), secs=(g[4], e[4]),
                slabs=tuple(c.chunk_len + c.n_max for c in cfgs))


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


def phase_k2_case(name: str, device, cfg, chunk, state, tables, sec,
                  bitwise_only: bool = False) -> dict:
    """K2 (track_chunk_packed on the card) against the eager loop with the
    plain correlator, from the same carry; returns k2_compare's readings.
    ``bitwise_only``: the case fails unless K2 gives the plain version's
    very bits."""
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
    if bitwise_only and device.type == "cuda" and not bitwise:
        raise SystemExit(f"K2 is not bit for bit its plain version at "
                         f"{name}")
    return r


def _worst(a: dict | None, b: dict) -> dict:
    """The larger error and tolerance ratio of two cases' readings."""
    keys = ("max_abs_err", "float_tol_ratio", "prompt_tol_ratio")
    return {k: max(b[k], a[k] if a else 0.0) for k in keys}


def phase_k2_two_groups(device) -> dict:
    """Case (g): track_multi_packed's one dispatch of two groups (one K2
    launch each) against each group's eager loop with the plain correlator
    on its slab of the shared chunk."""
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    t0 = time.perf_counter()
    c = k2_two_group_case(device)
    before = tk.launches
    new, flat = trk.track_multi_packed(c["cfgs"], c["chunk"], c["states"],
                                       c["tables"], c["secs"], c["slabs"])
    launched = tk.launches - before
    worst, bitwise, off = None, True, 0
    for cfg, st, tab, sec, slab, ns in zip(c["cfgs"], c["states"],
                                           c["tables"], c["secs"],
                                           c["slabs"], new):
        rs, out = trk.track_chunk(cfg, c["chunk"][:slab], st, tab, sec,
                                  correlate=correlator.epoch_correlate_plain)
        ref = trk.pack_host_outputs(out, rs.loss_of_lock)
        n = ref.numel()
        got = flat[off: off + n].reshape(ref.shape)
        off += n
        if device.type == "cuda":
            torch.cuda.synchronize()
        r = k2_compare(got, ref, ns, rs)
        if r["bad"]:
            raise SystemExit(f"K2 disagrees with its plain version in the "
                             f"two-group dispatch: {r['bad']}")
        bitwise = bitwise and torch.equal(got.view(torch.int32),
                                          ref.view(torch.int32)) \
            and torch.equal(tk.pack_carry(ns), tk.pack_carry(rs))
        worst = _worst(worst, r)
    if off != flat.numel():
        raise SystemExit("two-group dispatch: flat output of the wrong size")
    _line("K2", t0, case="g_two_groups", groups="1C@4MSps+1B_pilot",
          steps=[cfg.n_steps for cfg in c["cfgs"]],
          n_max=[cfg.n_max for cfg in c["cfgs"]],
          launches=launched if device.type == "cuda" else 0,
          max_abs_err=f"{worst['max_abs_err']:.3e}",
          float_tol_ratio=f"{worst['float_tol_ratio']:.3e}",
          prompt_tol_ratio=f"{worst['prompt_tol_ratio']:.3e}",
          bitwise=bitwise, ok=True)
    if device.type == "cuda" and launched != 2:
        raise SystemExit(f"two-group dispatch launched K2 {launched} times")
    return worst


# K2 cases: GPS L1 C/A at 2 MSps (plain, extended + secondary code, a
# 16-chunk dispatch), then this slice's Galileo E1 shapes at 4 MSps, C=6,
# 27 steps, n_max 16064 (the tiled window): (e) E1-B with VEML taps, (f)
# pilot tracking on E1-C with the E1-B data prompt, and pilot tracking with
# extended integration and the CS25 wipe
K2_CASES = (("plain", {}), ("extended", dict(extended=True)),
            ("k16", dict(chunks=16)),
            ("e_e1b", dict(signal="1B")),
            ("f_e1_pilot", dict(signal="1B", pilot=True)),
            ("f_e1_pilot_extended", dict(signal="1B", pilot=True,
                                         extended=True)),
            # the wideband shapes, 102 steps per chunk, 10,230-entry tables,
            # three 4096-sample tiles per epoch: (h) GPS L5I at 11 MSps,
            # C=4; (i) L5Q pilot tracking with the NH10 wipe after the
            # extension; (j) Galileo E5a-I at 12 MSps, C=4, with the CS20
            # wipe; (k) E5a-Q pilot tracking
            ("h_l5", dict(signal="L5", n_channels=4)),
            ("i_l5_pilot_nh10", dict(signal="L5", pilot=True,
                                     extended=True)),
            ("j_e5a_cs20", dict(signal="5X", n_channels=4, extended=True)),
            ("k_e5a_pilot", dict(signal="5X", pilot=True)),
            # (m) BeiDou B1I at 4 MSps (n_max 4064, 2046-entry tables) with
            # the NH20 wipe over one secondary period after the extension;
            # GPS L2C's 20 ms windows and GLONASS L1's FDMA channels run in
            # phase_k2_two_dispatches
            ("m_b1i_nh20", dict(signal="B1", extended=True)),
            # (o) GLONASS L2 C/A at 6 MSps (n_max 6064, 511-entry tables),
            # each channel at its slot's IF (+6, -7, 0, -4, +2 x 437.5 kHz);
            # (p) BeiDou B3I at 12 MSps (n_max 12,064, 10,230-entry tables)
            # with the NH20 wipe after the extension
            ("o_glo_l2", dict(signal="2G")),
            ("p_b3i_nh20", dict(signal="B3", extended=True)))


def phase_k2_two_dispatches(name: str, device, per_dispatch: int = 1,
                            bitwise_only: bool = False, **kw) -> dict:
    """Cases (l) and (n): two consecutive one-chunk dispatches, the carry K2
    wrote for the first fed to the second (the receiver's chunk boundary:
    each dispatch's window is its chunk plus the halo, the next chunk
    starts chunk_len later), against the eager loop with the plain
    correlator doing the same; at GPS L2C's shape (2 MSps, 20 ms code
    epochs of 40,000 samples, n_max 40,064, 7 steps a chunk, the last window
    of a chunk reaching into its halo) on 5 channels, and at GLONASS L1's
    (8 MSps, n_max 8064, 102 steps) on 6, the live ones at slots -7, 0,
    +6, +3 and -2 (IFs of -3.94 to +3.38 MHz); case (q), the Kalman
    carrier loop at GPS L1 on 8 channels, two dispatches of
    ``per_dispatch`` chunks each, held bit for bit (``bitwise_only``)."""
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    t0 = time.perf_counter()
    cfg2, chunk, state, tables, sec = k2_case(device,
                                              chunks=2 * per_dispatch, **kw)
    n = cfg2.chunk_len // 2
    cfg = dataclasses.replace(cfg2, chunk_len=n, n_steps=int(
        np.ceil(n / cfg2.samples_per_code)) + 2)
    worst, bitwise, ks, rs = None, True, state, state
    before = tk.launches
    for i in range(2):
        part = chunk[i * n: i * n + n + cfg.n_max]
        ks, packed = trk.track_chunk_packed(cfg, part, ks, tables, sec)
        rs, out = trk.track_chunk(cfg, part, rs, tables, sec,
                                  correlate=correlator.epoch_correlate_plain)
        ref = trk.pack_host_outputs(out, rs.loss_of_lock)
        if device.type == "cuda":
            torch.cuda.synchronize()
        r = k2_compare(packed, ref, ks, rs)
        if r["bad"]:
            raise SystemExit(f"K2 disagrees with its plain version at {name}"
                             f", dispatch {i}: {r['bad']}")
        bitwise = bitwise and torch.equal(
            packed.view(torch.int32), ref.view(torch.int32)) and torch.equal(
            tk.pack_carry(ks), tk.pack_carry(rs))
        worst = _worst(worst, r)
        if bitwise_only and device.type == "cuda" and not bitwise:
            raise SystemExit(f"K2 is not bit for bit its plain version at "
                             f"{name}, dispatch {i}")
    launched = tk.launches - before
    _line("K2", t0, case=name, C=int(tables.shape[0]), steps=cfg.n_steps,
          n_max=cfg.n_max, dispatches=2,
          launches=launched if device.type == "cuda" else 0,
          end_states=np.bincount(trk.as_state(ks).state.cpu().numpy(),
                                 minlength=4).tolist(),
          max_abs_err=f"{worst['max_abs_err']:.3e}",
          float_tol_ratio=f"{worst['float_tol_ratio']:.3e}",
          prompt_tol_ratio=f"{worst['prompt_tol_ratio']:.3e}",
          bitwise=bitwise, ok=True)
    if device.type == "cuda" and launched != 2:
        raise SystemExit(f"{name}: K2 launched {launched} times for 2 "
                         f"dispatches")
    return worst


def phase_k2(device, with_k16: bool) -> dict:
    worst = None
    for name, kw in K2_CASES:
        if name == "k16" and not with_k16:
            continue
        worst = _worst(worst, phase_k2_case(name, device,
                                            *k2_case(device, **kw)))
    worst = _worst(worst, phase_k2_two_dispatches(
        "l_l2c_two_dispatches", device, signal="2S", n_channels=5))
    worst = _worst(worst, phase_k2_two_dispatches(
        "n_glo_l1_two_dispatches", device, signal="1G"))
    return _worst(worst, phase_k2_two_groups(device))


# the forced cluster sizes' cases: GPS L1 C/A, the E1 pilot and the E5a
# pilot handoffs (6 channels), GPS L2C's 40,064-sample windows (5), GLONASS
# L1's FDMA channels and B3I with the NH20 wipe (6)
K2_CLUSTER_CASES = (("plain", {}), ("f_e1_pilot", dict(signal="1B", pilot=True)),
                    ("k_e5a_pilot", dict(signal="5X", pilot=True)),
                    ("l_l2c", dict(signal="2S", n_channels=5)),
                    ("n_glo_l1", dict(signal="1G")),
                    ("p_b3i_nh20", dict(signal="B3", extended=True)))


def phase_k2_clusters(device, cases=K2_CLUSTER_CASES) -> None:
    """K2 at every cluster size m (forced) on ``cases``: each launch gives
    the plain version's bits, packed rows and carry (the split of a
    channel's lanes over m blocks keeps the sums' order)."""
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    for name, kw in cases:
        t0 = time.perf_counter()
        cfg, chunk, state, tables, sec = k2_case(device, **kw)
        ref_state, out = trk.track_chunk(
            cfg, chunk, state, tables, sec,
            correlate=correlator.epoch_correlate_plain)
        ref = trk.pack_host_outputs(out, ref_state.loss_of_lock)
        ref_carry = tk.pack_carry(ref_state)
        chosen = tk.cluster_size(cfg, tables.shape[0], chunk.shape[0],
                                 tables.shape[-1], 0 if sec is None
                                 else sec.shape[1], device.index or 0)
        bits = {}
        for m in tk.CLUSTER_SIZES:
            carry, packed = tk.track_chunk_carry(
                cfg, chunk, tk.pack_carry(state), tables, sec, cluster=m)
            torch.cuda.synchronize()
            bits[m] = (torch.equal(packed.view(torch.int32),
                                   ref.view(torch.int32))
                       and torch.equal(carry, ref_carry))
        _line("K2", t0, case=f"{name}_forced_m", C=int(tables.shape[0]),
              steps=cfg.n_steps, chosen_m=chosen,
              bitwise_by_m=json.dumps({str(m): b for m, b in bits.items()}
                                      ).replace(" ", ""),
              ok=all(bits.values()))
        if not all(bits.values()):
            raise SystemExit(f"K2 at a forced cluster size is not bit for "
                             f"bit its plain version at {name}: {bits}")


def phase_k2_kf(device) -> dict:
    """The Kalman carrier loop in K2 (its KF variants), every case bit for bit
    its plain version: (q) GPS L1 at C=8 over two dispatches of 200 ms, the
    second from the carry K2 wrote (kf_p and kf_acc included; the channels
    leave pull-in at epoch 100, so ~300 KF updates); (r) GPS L5I at 11
    MSps, C=4, one 200 ms dispatch (the flag is generic); (q) again at every
    forced cluster size. The dynamic receiver's KF carry is case (s), after
    the kf phase."""
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk

    before = tk.kf_launches
    worst = phase_k2_two_dispatches(
        "q_kf_gps_two_dispatches", device, per_dispatch=2,
        bitwise_only=True, carrier_kf=True, n_channels=8)
    worst = _worst(worst, phase_k2_case(
        "r_kf_l5", device, *k2_case(device, signal="L5", n_channels=4,
                                    chunks=2, carrier_kf=True),
        bitwise_only=True))
    if device.type == "cuda":
        phase_k2_clusters(device, (("q_kf_gps", dict(
            carrier_kf=True, chunks=2, n_channels=8)),))
    if device.type == "cuda" and tk.kf_launches == before:
        raise SystemExit("the KF cases launched no KF variant of K2")
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
    n_taps = cfg.n_taps
    nbytes = (window * 8 + n_ch * table_len * 4 + 2 * n_ch * width * 4
              + cfg.n_steps * n_ch * 13 * 4)
    flops = float(ns.sum()) * (16 + 6 * n_taps) + valid.sum() * K2_UPDATE_FLOPS
    return float(nbytes), float(flops)


# K2's timing shapes: GPS L1 C/A at 2 MSps (the main path's), Galileo
# E1-B + E1-C pilot at 4 MSps (the hybrid receiver's Galileo group), GPS L5I
# at 11 MSps and Galileo E5a-I + E5a-Q pilot at 12 MSps
K2_TIMING = (("k2_c8", dict(n_channels=8)), ("k2_c128", dict(n_channels=128)),
             ("k2_e1p_c6", dict(signal="1B", pilot=True, n_channels=6)),
             ("k2_e1p_c128", dict(signal="1B", pilot=True, n_channels=128)),
             ("k2_l5_c4", dict(signal="L5", n_channels=4)),
             ("k2_l5_c128", dict(signal="L5", n_channels=128)),
             ("k2_e5ap_c4", dict(signal="5X", pilot=True, n_channels=4)),
             ("k2_e5ap_c128", dict(signal="5X", pilot=True,
                                   n_channels=128)),
             # the shipped L5 conf's pilot tracking on its 6 channels, and
             # the in-process e5a receiver's data-only tracking
             ("k2_l5p_c6", dict(signal="L5", pilot=True, n_channels=6)),
             ("k2_e5a_c4", dict(signal="5X", n_channels=4)),
             # GPS L2C at 2 MSps (7 steps of 40,000 samples a chunk) and
             # BeiDou B1I at 4 MSps (102 steps of 4,000), at the receivers'
             # channel counts and at 128
             ("k2_l2c_c5", dict(signal="2S", n_channels=5)),
             ("k2_l2c_c128", dict(signal="2S", n_channels=128)),
             ("k2_b1i_c4", dict(signal="B1", n_channels=4)),
             ("k2_b1i_c128", dict(signal="B1", n_channels=128)),
             # the dynamic receiver's 6 GPS L1 C/A channels
             ("k2_dyn_c6", dict(n_channels=6)),
             # GLONASS L1 C/A at 8 MSps and L2 C/A at 6 MSps (102 steps of
             # 8,000 / 6,000 samples, every channel at its slot's IF) and
             # BeiDou B3I at 12 MSps (102 steps of 12,000), at the
             # receivers' channel counts and at 128
             ("k2_glo1_c5", dict(signal="1G", n_channels=5)),
             ("k2_glo1_c128", dict(signal="1G", n_channels=128)),
             ("k2_glo2_c4", dict(signal="2G", n_channels=4)),
             ("k2_b3i_c4", dict(signal="B3", n_channels=4)),
             ("k2_b3i_c128", dict(signal="B3", n_channels=128)))

# K2 of another checkout (the parent commit's, say), timed at the same
# shapes in a process of its own: the kernel's own time per launch, in ms,
# printed as one JSON object
BASELINE_TIMING = r"""
import json, sys, torch
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.utils import scenario
dev = torch.device("cuda", 0)
out = {}
for name, kw in json.loads(sys.argv[1]):
    try:
        c = scenario.tracking_handoff_case(dev, **kw)
    except (KeyError, ValueError):
        continue                  # a signal that checkout has not ported
    chunk = torch.from_numpy(c["chunk"]).to(dev)
    tables = torch.from_numpy(c["tables"]).to(dev)
    carry = tk.pack_carry(c["state"])
    packed = torch.empty((c["cfg"].n_steps, tables.shape[0], tk.PACKED_COLS),
                         device=dev)
    args = tk.kernel_args(c["cfg"], chunk, carry, tables, None,
                          torch.empty_like(carry), packed)
    ts = []
    for n in (3, 20, 20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            tk.launch_kernel(args)
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / n)
    out[name] = ts[1:]
print(json.dumps(out))
"""


def _baseline_times(baseline: pathlib.Path) -> dict:
    """BASELINE_TIMING run in ``baseline`` (a checkout of the repository):
    {shape: [ms, ms]}."""
    baseline = pathlib.Path(baseline).resolve()
    shapes = json.dumps([[n, kw] for n, kw in K2_TIMING])
    done = subprocess.run([sys.executable, "-c", BASELINE_TIMING, shapes],
                          cwd=baseline, capture_output=True, text=True,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(baseline)},
                          timeout=600)
    if done.returncode != 0:
        raise SystemExit(f"baseline K2 timing failed:\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def phase_timing_k2(device, smi: str, baseline=None) -> dict:
    """K2 per 100 ms chunk at each K2_TIMING shape: the raw launch at the
    chosen cluster size and at m=1, in turns (chosen, m=1, m=1, chosen), with
    the eager loop on the plain correlator and (single-component tables
    only: K1 does not route taps) on K1, both host-bound, one call each per
    turn; the step split into its parts by the timing builds that leave
    parts out (tk.PART_BUILDS), at the chosen m. With ``baseline`` (a
    checkout), that checkout's K2 at the same shapes before and after."""
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    results = {}
    base_a = _baseline_times(baseline) if baseline else {}
    for name, kw in K2_TIMING:
        t0 = time.perf_counter()
        cfg, chunk, state, tables, _ = k2_case(device, **kw)
        n_ch = tables.shape[0]
        carry = tk.pack_carry(state)
        carry_out = torch.empty_like(carry)
        packed = torch.empty((cfg.n_steps, n_ch, tk.PACKED_COLS),
                             dtype=torch.float32, device=device)

        kargs = tk.kernel_args(cfg, chunk, carry, tables, None, carry_out,
                               packed)
        kargs1 = tk.kernel_args(cfg, chunk, carry, tables, None, carry_out,
                                packed, cluster=1)
        m = kargs[0].cluster

        def kernel():
            tk.launch_kernel(kargs)

        def kernel_m1():
            tk.launch_kernel(kargs1)

        def plain():
            st, o = trk.track_chunk(cfg, chunk, state, tables,
                                    correlate=correlator.epoch_correlate_plain)
            trk.pack_host_outputs(o, st.loss_of_lock)

        def eager_k1():
            st, o = trk.track_chunk(cfg, chunk, state, tables)
            trk.pack_host_outputs(o, st.loss_of_lock)

        def wrapper():
            trk.track_chunk_packed(cfg, chunk, state, tables)

        with_k1 = not cfg.track_pilot
        _time_ms(kernel, 3)                               # warm-up
        _time_ms(kernel_m1, 3)
        for fn in (plain, wrapper) + ((eager_k1,) if with_k1 else ()):
            _time_ms(fn, 1)
        p1 = _time_ms(plain, 1)
        k_a = _time_ms(kernel, 20)
        m1_a = _time_ms(kernel_m1, 20)
        m1_b = _time_ms(kernel_m1, 20)
        k_b = _time_ms(kernel, 20)
        p2 = _time_ms(plain, 1)
        # every cluster size, in turn after the chosen one and m=1
        sweep = {}
        for mm in tk.CLUSTER_SIZES:
            ka = tk.kernel_args(cfg, chunk, carry, tables, None, carry_out,
                                packed, cluster=mm)
            tk.launch_kernel(ka)                          # warm-up
            sweep[mm] = _time_ms(lambda: tk.launch_kernel(ka), 20)
        parts = {}
        for part, target in tk.PART_BUILDS.items():
            tk.launch_kernel(kargs, target)               # warm-up
            parts[part] = _time_ms(lambda: tk.launch_kernel(kargs, target),
                                   20)
        full = (k_a + k_b) / 2
        us = 1e3 / cfg.n_steps                            # ms per chunk -> us per step
        split = dict(
            fill_us=parts["fill"] * us,
            accumulate_us=(parts["fill_accumulate"] - parts["fill"]) * us,
            reduce_us=(parts["fill_accumulate_reduce"]
                       - parts["fill_accumulate"]) * us,
            update_us=(full - parts["fill_accumulate_reduce"]) * us)
        e1 = _time_ms(eager_k1, 1) if with_k1 else float("nan")
        e2 = _time_ms(eager_k1, 1) if with_k1 else float("nan")
        w = _time_ms(wrapper, 20)
        _, out = trk.track_chunk(cfg, chunk, state, tables,
                                 correlate=correlator.epoch_correlate_plain)
        nbytes, flops = k2_work(cfg, out, n_ch, tables[0].numel(),
                                carry.shape[1])
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        r = dict(ms=full, m1_ms=(m1_a + m1_b) / 2, cluster=m, split=split,
                 sweep=sweep,
                 plain_ms=(p1 + p2) / 2,
                 eager_k1_ms=(e1 + e2) / 2, wrapper_ms=w,
                 bound_ms=max(t_bytes, t_flops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_flops else "operations",
                 steps=cfg.n_steps, n_max=cfg.n_max,
                 smem=tk.shared_bytes(cfg.n_max, tables.shape[-1],
                                      2 if cfg.track_pilot else 1))
        results[name] = r
        _line("timing", t0, shape=name, C=n_ch, steps=cfg.n_steps,
              n_max=cfg.n_max, tile=tk.tile_len(cfg.n_max),
              shared_bytes=tk.shared_bytes(
                  cfg.n_max, tables.shape[-1],
                  2 if cfg.track_pilot else 1, m),
              cluster=m, kernel_ms=f"{r['ms']:.4f}",
              kernel_turns_ms=f"{k_a:.4f}/{k_b:.4f}",
              m1_ms=f"{r['m1_ms']:.4f}", m1_turns_ms=f"{m1_a:.4f}/{m1_b:.4f}",
              by_m_ms="/".join(f"{mm}:{t:.4f}" for mm, t in sweep.items()),
              step_us=f"{full * us:.3f}",
              **{k: f"{v:.3f}" for k, v in split.items()},
              wrapper_ms=f"{w:.4f}",
              eager_plain_ms=f"{r['plain_ms']:.3f}",
              eager_plain_turns_ms=f"{p1:.3f}/{p2:.3f}",
              eager_k1_ms=f"{r['eager_k1_ms']:.3f}",
              bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
              bytes=int(nbytes), flops=int(flops), card=f'"{smi}"')
    if baseline:
        base_b = _baseline_times(baseline)
        for name, _ in K2_TIMING:
            if name not in base_a:
                continue
            a, b = base_a[name], base_b[name]
            results[name]["baseline_ms"] = (sum(a) + sum(b)) / 4
            _line("timing", time.perf_counter(), shape=name,
                  baseline=f'"{baseline}"',
                  baseline_ms=f"{results[name]['baseline_ms']:.4f}",
                  baseline_turns_ms="/".join(f"{v:.4f}" for v in a + b),
                  kernel_ms=f"{results[name]['ms']:.4f}",
                  m1_ms=f"{results[name]['m1_ms']:.4f}", card=f'"{smi}"')
    return results


# the KF variant's timing shapes: GPS L1 C/A at 2 MSps on the main path's 8
# channels and at 128, every channel past pull-in (the carry after one
# dispatch), so the KF updates every epoch
K2_KF_TIMING = (("k2_kf_c8", 8), ("k2_kf_c128", 128))


def phase_timing_kf(device, smi: str) -> dict:
    """K2's KF variant per 100 ms chunk at K2_KF_TIMING's shapes: the second
    chunk of a 200 ms handoff, from the carry K2 wrote for the first (the
    channels in WIDE_TRACK: the KF runs at every boundary), in turns with
    the non-KF variant on the same carry and chunk (kf, non-KF, non-KF,
    kf) and with the eager loop with the KF on the plain correlator;
    the bound adds K2_KF_FLOPS per KF update to k2_work's count."""
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    results = {}
    for name, n_ch in K2_KF_TIMING:
        t0 = time.perf_counter()
        cfg2, chunk2, state, tables, _ = k2_case(
            device, chunks=2, n_channels=n_ch, carrier_kf=True)
        n = cfg2.chunk_len // 2
        cfg = dataclasses.replace(cfg2, chunk_len=n, n_steps=int(
            np.ceil(n / cfg2.samples_per_code)) + 2)
        plain_cfg = dataclasses.replace(cfg, carrier_kf=False)
        carry, _ = tk.track_chunk_carry(cfg, chunk2[: n + cfg.n_max],
                                        tk.pack_carry(state), tables)
        chunk = chunk2[n: 2 * n + cfg.n_max].contiguous()
        st1 = tk.unpack_carry(carry)
        carry_out = torch.empty_like(carry)
        packed = torch.empty((cfg.n_steps, n_ch, tk.PACKED_COLS),
                             dtype=torch.float32, device=device)
        kargs = tk.kernel_args(cfg, chunk, carry, tables, None, carry_out,
                               packed)
        pargs = tk.kernel_args(plain_cfg, chunk, carry, tables, None,
                               carry_out, packed)

        def kernel():
            tk.launch_kernel(kargs)

        def kernel_non_kf():
            tk.launch_kernel(pargs)

        def plain():
            st, o = trk.track_chunk(cfg, chunk, st1, tables,
                                    correlate=correlator.epoch_correlate_plain)
            trk.pack_host_outputs(o, st.loss_of_lock)

        _time_ms(kernel, 3)                               # warm-up
        _time_ms(kernel_non_kf, 3)
        plain()
        p1 = _time_ms(plain, 1)
        k_a = _time_ms(kernel, 20)
        d_a = _time_ms(kernel_non_kf, 20)
        d_b = _time_ms(kernel_non_kf, 20)
        k_b = _time_ms(kernel, 20)
        p2 = _time_ms(plain, 1)
        _, out = trk.track_chunk(cfg, chunk, st1, tables,
                                 correlate=correlator.epoch_correlate_plain)
        nbytes, flops = k2_work(cfg, out, n_ch, tables[0].numel(),
                                carry.shape[1])
        # the KF's state is 10 more words a channel each way, counted in
        # the carry's width already; its updates: every boundary past
        # pull-in
        kf_updates = int(((out.state >= trk.WIDE_TRACK) & out.valid)
                         .sum().item())
        flops += kf_updates * K2_KF_FLOPS
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        r = dict(ms=(k_a + k_b) / 2, non_kf_ms=(d_a + d_b) / 2,
                 plain_ms=(p1 + p2) / 2, cluster=kargs[0].cluster,
                 bound_ms=max(t_bytes, t_flops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_flops else "operations",
                 kf_updates=kf_updates, steps=cfg.n_steps)
        results[name] = r
        _line("timing", t0, shape=name, C=n_ch, steps=cfg.n_steps,
              cluster=r["cluster"], kf_kernel_ms=f"{r['ms']:.4f}",
              kf_turns_ms=f"{k_a:.4f}/{k_b:.4f}",
              non_kf_ms=f"{r['non_kf_ms']:.4f}",
              non_kf_turns_ms=f"{d_a:.4f}/{d_b:.4f}",
              kf_updates=kf_updates, eager_plain_ms=f"{r['plain_ms']:.3f}",
              eager_plain_turns_ms=f"{p1:.3f}/{p2:.3f}",
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


def _breakdown(phase: str, t0: float, spent: dict, rx, **extra) -> None:
    """The host seconds of each receiver stage (``_timed``) as one line;
    the wait for the packed outputs is finish minus consume."""
    wait = spent["_finish_tracking"] - spent["_consume_tracking"]
    n_disp = max(rx.tracking_dispatches, 1)
    up = rx.upload_seconds
    _line(phase, t0, step="breakdown",
          upload_s=f"{spent['_upload']:.3f}",
          upload_quantize_s=f"{up['quantize']:.3f}",
          upload_copy_s=f"{up['copy']:.3f}",
          upload_dequant_s=f"{up['dequant']:.3f}",
          acquisition_s=f"{spent['_run_acquisition']:.3f}",
          tracking_enqueue_s=f"{spent['_dispatch_tracking']:.3f}",
          tracking_wait_s=f"{wait:.3f}",
          telemetry_consume_s=f"{spent['_consume_tracking']:.3f}",
          observables_pvt_s=f"{spent['_run_observables']:.3f}",
          enqueue_us_per_dispatch=f"{spent['_dispatch_tracking'] / n_disp * 1e6:.1f}",
          **extra)


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
    _breakdown("main", t0, spent, rx,
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


def _final_carry_case(rx, x: np.ndarray, group: int = 0) -> tuple:
    """(cfg, chunk, carry, tables, sec): a group's own dispatch on its
    final carry (as a TrackingState), over the stream's first chunk as the
    receiver uploads it."""
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    g = rx.groups[group]
    cfg = g.trk_cfg
    return (cfg, rx._upload(x[: cfg.chunk_len + cfg.n_max]),
            trk.as_state(g.trk_state), g._tables_dev, g._sec_dev)


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
    return _shipped_conf("gps_l1_file.conf",
                         {"SignalSource.filename": capture}, keys)


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
    m = re.search(r"tracking_kernel_kf_launches=(\d+)", stdout)
    got["kf"] = int(m.group(1)) if m else 0
    m = re.search(r"last fix: lat=([-\d.]+) lon=([-\d.]+) h=([-\d.]+) m",
                  stdout)
    if m is not None:
        got["fix_llh"] = tuple(map(float, m.groups()))
    return got


def _cli_fix_error(got: dict, sc) -> dict:
    """The CLI's last fix (``_summary``'s ``fix_llh``) against the
    scenario's truth: {err_2d_m, err_3d_m}, empty without a fix."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy

    if "fix_llh" not in got:
        return {}
    lat, lon, h = got["fix_llh"]
    pos = geodesy.geodetic_to_ecef(np.deg2rad(lat), np.deg2rad(lon), h)
    enu = geodesy.ecef_to_enu(pos - sc.rcv_ecef, *sc.rcv_llh[:2])
    return dict(err_2d_m=float(np.hypot(enu[0], enu[1])),
                err_3d_m=float(np.linalg.norm(enu)))


def _nav_of(rx, path) -> dict:
    """The receiver's ephemerides through the RINEX nav writer and reader,
    as the CLI's nav file holds them."""
    from gnss_sdr_tpu_torch.receiver.pvt.rinex import (RinexNavReader,
                                                       RinexNavWriter)

    w = RinexNavWriter(path)
    for (sys_, _), e in rx.ephemerides.items():
        w.write_ephemeris(e, system=sys_)
    w.close()
    return RinexNavReader(path).read() if rx.ephemerides else {}


def phase_cli(device, main_run: dict, cond_s: float) -> int:
    """The CLI on the main phase's capture (checks above, phase 8), then a
    conditioned run of ``cond_s`` seconds at 4 MSps. Returns the CLI's K2
    launches."""
    from gnss_sdr_tpu_torch.receiver.pvt.rinex import (RinexNavReader,
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
        main_nav = _nav_of(rx, tmp / "main.nav")
        eph_equal = (sorted(nav) == sorted(main_nav) and all(
            dataclasses.asdict(nav[k]) == dataclasses.asdict(main_nav[k])
            for k in nav))
        checks = dict(device_line=f"device: {platform}" in stderr,
                      gga=nmea.count("$GPGGA"), obs_prns=obs_prns,
                      nav_ephemerides=len(nav), eph_equal_main=eph_equal)
        err = _cli_fix_error(got, sc)
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


# ---------------------------------------------------------------- hybrid ---
HYB_FS = 4.0e6
HYB_T0 = 352800.13


def hybrid_capture(duration_s: float, device=None) -> dict:
    """tests/test_e2e_hybrid.py's scenario: 4 GPS L1 C/A satellites at 47
    dB-Hz and 4 Galileo E1 satellites at 48 dB-Hz (vis_offset 3, 0 degree
    mask) on one 4 MSps stream, clean signals from seeds 31 and 32 summed
    with one unit-variance noise floor from seed 33. The Galileo signals
    carry their E1-C pilot (with CS25), as real E1 signals do, so the
    shipped conf's pilot tracking has a pilot to track. With a ``device``
    the clean signals are summed there (the generator's torch path)."""
    from gnss_sdr_tpu_torch.utils import generator, scenario

    sc_g = scenario.build_gps_l1_scenario(t0_gps=HYB_T0, duration_s=duration_s,
                                          fs=HYB_FS, n_sats=4, cn0_dbhz=47.0)
    sc_e = scenario.build_galileo_e1_scenario(
        t0_gps=HYB_T0, duration_s=duration_s, fs=HYB_FS, n_sats=4,
        cn0_dbhz=48.0, vis_offset=3, el_mask_deg=0.0)
    x = sc_g.generate(seed=31, noise=False, device=device)
    x += generator.generate(sc_e.spec, sc_e.sats, HYB_FS, duration_s,
                            seed=32, noise=False, with_pilot=True,
                            device=device)
    rng = np.random.default_rng(33)
    n = len(x)
    x += ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
          / np.sqrt(2.0)).astype(np.complex64)
    return dict(sc_g=sc_g, sc_e=sc_e, x=x, duration_s=duration_s)


def _fix_error(fixes, sc) -> tuple:
    """(2D, 3D) error of the mean ENU offset of ``fixes`` from the truth."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy

    lat, lon, _ = sc.rcv_llh
    enu = np.stack([geodesy.ecef_to_enu(f.pos_ecef - sc.rcv_ecef, lat, lon)
                    for f in fixes]).mean(axis=0)
    return float(np.hypot(enu[0], enu[1])), float(np.linalg.norm(enu))


def phase_hybrid(device, cap: dict, check: bool) -> dict:
    """The in-process hybrid receiver (two signal groups, 6 + 6 channels)
    on the hybrid capture, with tests/test_e2e_hybrid.py's loop settings:
    each system tracks >= 3 of its satellites, >= 2 ephemerides per system
    (>= 5 in all) equal to the truth, a mixed G + E fix with |ISB| < 1 us
    and 2D < 2 m / 3D < 5 m over the last 5 mixed fixes, one K2 launch per
    group dispatch and no K1 launch; with the host seconds of each receiver
    stage."""
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    sc_g, sc_e, x = cap["sc_g"], cap["sc_e"], cap["x"]
    t0 = time.perf_counter()
    cfg = ReceiverConfig(
        fs=HYB_FS, chunk_ms=100,
        signal_plan=(("1C", 6, tuple(sc_g.prns)), ("1B", 6, tuple(sc_e.prns))),
        acq_doppler_max_hz=5000.0, acq_doppler_step_hz=125.0,
        pll_bw_hz=20.0, dll_bw_hz=2.0, pll_bw_narrow_hz=8.0,
        dll_bw_narrow_hz=0.75, pvt_apply_tropo=False, pvt_apply_iono=False)
    rx = Receiver(cfg, device=device)
    spent: dict = {}
    _timed(rx, ("_upload", "_run_acquisition", "_dispatch_tracking",
                "_finish_tracking", "_consume_tracking", "_run_observables"),
           spent)
    correlator.launches = 0
    tk.launches = 0
    rx.run_source(ArraySignalSource(x, HYB_FS))
    if device.type == "cuda":
        torch.cuda.synchronize()
    k1, k2 = correlator.launches, tk.launches
    wall = time.perf_counter() - t0
    dur = cap["duration_s"]
    tracked = [sorted(ch.prn for ch in g.channels if ch.state == "tracking")
               for g in rx.groups]
    _line("hybrid", t0, step="receiver", wall_s=f"{wall:.3f}",
          realtime_x=f"{dur / wall:.3f}", tracked_gps=tracked[0],
          tracked_gal=tracked[1], scenario_gps=sorted(sc_g.prns),
          scenario_gal=sorted(sc_e.prns), chunks=rx._chunk_index,
          group_dispatches=rx.tracking_dispatches, scan_steps=rx.scan_steps,
          k2_launches=k2, k1_launches=k1)
    _breakdown("hybrid", t0, spent, rx)
    bad = []
    if len(set(tracked[0]) & set(sc_g.prns)) < 3:
        bad.append(f"GPS tracked {tracked[0]}")
    if len(set(tracked[1]) & set(sc_e.prns)) < 3:
        bad.append(f"Galileo tracked {tracked[1]}")
    if device.type == "cuda" and not (k2 == rx.tracking_dispatches > 0
                                      and k1 == 0):
        bad.append(f"K2 launches {k2} != group dispatches "
                   f"{rx.tracking_dispatches}, or K1 launched {k1} times")
    if check:
        ephs = rx.ephemerides
        truth = {"G": sc_g.ephemerides, "E": sc_e.ephemerides}
        wrong = [key for key, e in ephs.items()
                 if abs(e.sqrt_a - truth[key[0]][key[1]].sqrt_a) > 2.0 ** -19
                 or e.toe != truth[key[0]][key[1]].toe]
        per = {s: sum(1 for k in ephs if k[0] == s) for s in "GE"}
        mixed = [f for f in rx.fixes if set(f.system_clock_s) == {"E", "G"}]
        err = _fix_error(mixed[-5:], sc_g) if mixed else (np.inf, np.inf)
        isb = (mixed[-1].system_clock_s["E"] - mixed[-1].system_clock_s["G"]
               if mixed else np.inf)
        _line("hybrid", t0, step="checks", ephemerides_gps=per["G"],
              ephemerides_gal=per["E"], eph_mismatch=wrong,
              fixes=len(rx.fixes), mixed_fixes=len(mixed),
              isb_ns=f"{isb * 1e9:.3f}", err_2d_m=f"{err[0]:.3f}",
              err_3d_m=f"{err[1]:.3f}")
        if per["G"] < 2 or per["E"] < 2 or len(ephs) < 5 or wrong:
            bad.append(f"ephemerides {per}, wrong {wrong}")
        if not (abs(isb) < 1e-6 and err[0] < 2.0 and err[1] < 5.0):
            bad.append(f"mixed fix ISB {isb} s, error {err}")
    if bad:
        raise SystemExit(f"hybrid phase failed its checks: {bad}")
    return dict(rx=rx, k2_launches=k2, k1_launches=k1, wall_s=wall)


def phase_cli_hybrid(device, cap: dict, hyb: dict, check: bool) -> int:
    """The shipped conf/hybrid_gps_galileo.conf (6 + 6 channels, 4 MSps,
    Tracking_1B.track_pilot=true, Tracking_1C.extend_correlation_symbols=20)
    run by the CLI on the hybrid capture written as ishort: its capture path
    and item type replaced, its output files moved into a temporary
    directory, and PVT.trop_model / iono_model OFF (the simulation has no
    atmosphere, as in the cli phase). Exit 0, a device line naming cuda,
    both systems' satellites in the RINEX obs file, every G and E record of
    the RINEX nav file equal to the hybrid phase's ephemeris of that
    satellite (>= 2 per system), the last fix within 2D < 2 m / 3D < 5 m,
    one K2 launch per group dispatch. Returns the CLI's K2 launches."""
    from gnss_sdr_tpu_torch.receiver.pvt.rinex import (RinexNavReader,
                                                       RinexObsReader)

    platform = "cuda" if device.type == "cuda" else "cpu"
    sc_g, sc_e, rx = cap["sc_g"], cap["sc_e"], hyb["rx"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        _write_ishort(tmp / "capture.ishort", cap["x"])
        lines = []
        for ln in (ROOT / "conf" / "hybrid_gps_galileo.conf").read_text(
                ).splitlines():
            if ln.startswith("SignalSource.filename="):
                ln = f"SignalSource.filename={tmp / 'capture.ishort'}"
            elif ln.startswith("SignalSource.item_type="):
                ln = "SignalSource.item_type=ishort"
            elif ln.startswith("PVT.") and "_filename=" in ln:
                key, _, name = ln.partition("=")
                ln = f"{key}={tmp / pathlib.Path(name).name}"
            lines.append(ln)
        lines += ["PVT.trop_model=OFF", "PVT.iono_model=OFF"]
        conf = tmp / "hybrid.conf"
        conf.write_text("\n".join(lines) + "\n")
        t1 = time.perf_counter()
        stdout, stderr = _run_cli(conf, platform)
        cli_s = time.perf_counter() - t1
        got = _summary(stdout)
        obs = {}
        for _, ep in RinexObsReader(tmp / "fix.obs").read_epochs():
            for o in ep:
                obs.setdefault(o["system"], set()).add(o["prn"])
        nav = RinexNavReader(tmp / "fix.nav").read()
        ref = _nav_of(rx, tmp / "hybrid.nav")
        eph_equal = all(k in ref and dataclasses.asdict(nav[k])
                        == dataclasses.asdict(ref[k]) for k in nav)
        per = {s: sum(1 for k in nav if k[0] == s) for s in "GE"}
        err = _cli_fix_error(got, sc_g)
        gga = (tmp / "fix.nmea").read_text().count("$GPGGA")
        _line("cli", t0, run="hybrid_conf", cli_seconds=f"{cli_s:.3f}",
              tracked=got["tracked"], group_dispatches=got["dispatches"],
              k2_launches=got["k2"], k1_launches=got["k1"],
              obs_gps=sorted(obs.get("G", ())),
              obs_gal=sorted(obs.get("E", ())), nav_gps=per["G"],
              nav_gal=per["E"], nav_equal_hybrid=eph_equal, gga=gga,
              device_line=f"device: {platform}" in stderr,
              **{k: f"{v:.3f}" for k, v in err.items()})
        want_g, want_e = set(sc_g.prns), set(sc_e.prns)
        bad = [name for name, ok in (
            ("device line", f"device: {platform}" in stderr),
            ("K1 launches", got["k1"] == 0),
            ("K2 launches", device.type != "cuda"
             or got["k2"] == got["dispatches"] > 0),
            ("RINEX obs G", not check or len(obs.get("G", set()) & want_g) >= 3),
            ("RINEX obs E", not check or len(obs.get("E", set()) & want_e) >= 3),
            ("RINEX nav", not check or (eph_equal and per["G"] >= 2
                                        and per["E"] >= 2)),
            ("GGA sentences", not check or gga > 0),
            ("fix", not check or (err and err["err_2d_m"] < 2.0
                                  and err["err_3d_m"] < 5.0)))
            if not ok]
        if bad:
            raise SystemExit(f"hybrid CLI run failed its checks: {bad}")
    return got["k2"]


# ------------------------------------------------------------- wideband ---
# tests/test_e2e_l5.py's and tests/test_e2e_e5a.py's settings: the sample
# rate, the seed, the ReceiverConfig keywords; and the shipped conf
WIDE = {
    "L5": dict(fs=11.0e6, seed=77, conf="gps_l5.conf",
               rx=dict(n_channels=4, acq_doppler_max_hz=5000.0,
                       acq_doppler_step_hz=250.0)),
    "5X": dict(fs=12.0e6, seed=87, conf="galileo_e5a.conf",
               rx=dict(n_channels=4, acq_doppler_max_hz=5000.0,
                       acq_doppler_step_hz=125.0, pll_bw_hz=25.0,
                       dll_bw_hz=2.0)),
}


def wideband_capture(signal: str, device, duration_s: float | None) -> dict:
    """The scenario of tests/test_e2e_l5.py (30 s, 4 satellites, 50 dB-Hz,
    11 MSps, seed 77) or tests/test_e2e_e5a.py (4 satellites, 50 dB-Hz,
    12 MSps, ~47 s: the F/NAV 1-2-3 page set plus 7 s, seed 87), generated
    with the pilot component (L5Q; E5a-Q with CS100) so the shipped confs'
    pilot tracking and two-component acquisition have one; the signal sum
    on ``device`` (the generator's torch path), the noise the numpy draw of
    the seed. ``duration_s`` cuts the scenario (the CPU rehearsal)."""
    from gnss_sdr_tpu_torch.utils import scenario

    w = WIDE[signal]
    if signal == "L5":
        sc = scenario.build_gps_l5_scenario(duration_s=duration_s or 30.0,
                                            n_sats=4, cn0_dbhz=50.0,
                                            fs=w["fs"])
    else:
        sc = scenario.build_galileo_e5a_scenario(fs=w["fs"], n_sats=4,
                                                 cn0_dbhz=50.0)
        if duration_s:
            sc.duration_s = duration_s
    x = sc.generate(seed=w["seed"], with_pilot=True, device=device)
    return dict(sc=sc, x=x, signal=signal)


def phase_wideband(device, cap: dict, check: bool) -> dict:
    """The in-process GPS L5 or Galileo E5a receiver (4 channels, the JAX
    e2e test's settings) on its capture: every scenario satellite tracked,
    >= 4 ephemerides equal to the truth (sqrt_a within 1e-4, toe exact), the
    mean of the last 5 fixes within 2D < 2 m / 3D < 5 m, one K2 launch per
    tracking dispatch and no K1 launch; the host seconds of each stage and
    the real-time factor."""
    sc, x, signal = cap["sc"], cap["x"], cap["signal"]
    phase = "l5" if signal == "L5" else "e5a"
    w = WIDE[signal]
    run = _receiver_run(device, phase, sc, x, w["fs"], signal=signal,
                        **w["rx"])
    rx, bad = run["rx"], []
    if check:
        if run["tracked"] != sorted(sc.prns):
            bad.append(f"tracked {run['tracked']}")
        ephs, wrong = rx.ephemerides, _eph_mismatch(rx, sc, 1e-4)
        err = (_fix_error(rx.fixes[-5:], sc) if len(rx.fixes) >= 3
               else (np.inf, np.inf))
        _line(phase, run["t0"], step="checks", ephemerides=len(ephs),
              eph_mismatch=wrong, fixes=len(rx.fixes),
              err_2d_m=f"{err[0]:.3f}", err_3d_m=f"{err[1]:.3f}")
        if len(ephs) < 4 or wrong:
            bad.append(f"ephemerides {len(ephs)}, wrong {wrong}")
        if not (err[0] < 2.0 and err[1] < 5.0):
            bad.append(f"fix error {err}")
    if bad:
        raise SystemExit(f"{phase} phase failed its checks: {bad}")
    return run


def phase_cli_wideband(device, cap: dict, run: dict, check: bool) -> int:
    """The shipped conf/gps_l5.conf (6 channels, L5Q pilot tracking) or
    conf/galileo_e5a.conf (5 channels, noncoherent I/Q CAF acquisition
    over both components) run by the CLI on the wideband capture written as
    ishort: its capture path and item type replaced, NMEA and RINEX obs /
    nav output into a temporary directory, PVT.trop_model / iono_model OFF.
    Exit 0, a device line naming the platform, the scenario's satellites in
    the RINEX obs file, every nav record equal to the in-process run's
    ephemeris of that satellite, one K2 launch per dispatch, no K1 launch;
    for L5 the last fix within 2D < 2 m / 3D < 5 m. Returns the CLI's K2
    launches."""
    from gnss_sdr_tpu_torch.receiver.pvt.rinex import (RinexNavReader,
                                                       RinexObsReader)

    platform = "cuda" if device.type == "cuda" else "cpu"
    sc, signal, rx = cap["sc"], cap["signal"], run["rx"]
    w = WIDE[signal]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        _write_ishort(tmp / "capture.ishort", cap["x"])
        lines = []
        for ln in (ROOT / "conf" / w["conf"]).read_text().splitlines():
            if ln.startswith("SignalSource.filename="):
                ln = f"SignalSource.filename={tmp / 'capture.ishort'}"
            elif ln.startswith("SignalSource.item_type="):
                ln = "SignalSource.item_type=ishort"
            lines.append(ln)
        lines += [f"PVT.nmea_dump_filename={tmp / 'out.nmea'}",
                  f"PVT.rinex_obs_filename={tmp / 'out.obs'}",
                  f"PVT.rinex_nav_filename={tmp / 'out.nav'}",
                  "PVT.trop_model=OFF", "PVT.iono_model=OFF"]
        conf = tmp / "wide.conf"
        conf.write_text("\n".join(lines) + "\n")
        t1 = time.perf_counter()
        stdout, stderr = _run_cli(conf, platform)
        cli_s = time.perf_counter() - t1
        got = _summary(stdout)
        obs = sorted({o["prn"] for _, ep in
                      RinexObsReader(tmp / "out.obs").read_epochs()
                      for o in ep}) if (tmp / "out.obs").exists() else []
        nav = (RinexNavReader(tmp / "out.nav").read()
               if (tmp / "out.nav").exists() else {})
        ref = _nav_of(rx, tmp / "inproc.nav")
        eph_equal = all(k in ref and dataclasses.asdict(nav[k])
                        == dataclasses.asdict(ref[k]) for k in nav)
        err = _cli_fix_error(got, sc)
        _line("cli", t0, run=w["conf"].split(".")[0],
              cli_seconds=f"{cli_s:.3f}", tracked=got["tracked"],
              tracking_dispatches=got["dispatches"], k2_launches=got["k2"],
              k1_launches=got["k1"], obs_prns=obs, nav_records=len(nav),
              nav_equal_inprocess=eph_equal,
              device_line=f"device: {platform}" in stderr,
              **{k: f"{v:.3f}" for k, v in err.items()})
        bad = [name for name, ok in (
            ("device line", f"device: {platform}" in stderr),
            ("K1 launches", got["k1"] == 0),
            ("K2 launches", device.type != "cuda"
             or got["k2"] == got["dispatches"] > 0),
            ("RINEX obs", not check or obs == sorted(sc.prns)),
            ("RINEX nav", not check or (eph_equal and len(nav) >= 4)),
            ("fix", not check or signal != "L5" or (
                err and err["err_2d_m"] < 2.0 and err["err_3d_m"] < 5.0)))
            if not ok]
        if bad:
            raise SystemExit(f"{w['conf']} CLI run failed its checks: {bad}")
    return got["k2"]


def run_wideband(device, signal: str, check: bool,
                 duration_s: float | None = None) -> dict:
    """One wideband signal: its capture, the in-process phase, K2 on the
    receiver's final carry (``check``: the card run), the CLI on the
    shipped conf. Returns the launches and K2's worst reading."""
    t0 = time.perf_counter()
    cap = wideband_capture(signal, device, duration_s)
    phase = "l5" if signal == "L5" else "e5a"
    _line(phase, t0, step="generate", samples=len(cap["x"]),
          prns=sorted(cap["sc"].prns), with_pilot=True)
    run = phase_wideband(device, cap, check)
    err = None
    if check:
        err = phase_k2_case(f"{phase}_final_carry", device,
                            *_final_carry_case(run["rx"], cap["x"]))
    cli_k2 = phase_cli_wideband(device, cap, run, check)
    return dict(k2_launches=run["k2_launches"],
                k1_launches=run["k1_launches"], cli_k2=cli_k2, k2_err=err)


# ------------------------------------------------- dynamic, l2c and b1i ---
DYN_VEL_ENU = (12.0, -5.0, 0.0)       # tests/test_e2e_dynamic.py
L2C_FS, B1I_FS = 2.0e6, 4.0e6
GLO1_FS, GLO2_FS, B3I_FS = 8.0e6, 6.0e6, 12.0e6


def _receiver_run(device, phase: str, sc, x: np.ndarray, fs: float,
                  **cfg_kw) -> dict:
    """One in-process receiver on ``x`` with the scenario's PRNs as its
    pool, the solver without an atmosphere (the simulation has none): the
    receiver line (wall, real-time factor, tracked PRNs, dispatches, K1 /
    K2 launches) and the host seconds of each stage. Fails unless every
    tracking dispatch launched K2 once and K1 never ran (on the card)."""
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    t0 = time.perf_counter()
    cfg_kw.setdefault("prns", tuple(sc.prns))
    cfg = ReceiverConfig(fs=fs, chunk_ms=100, pvt_apply_tropo=False,
                         pvt_apply_iono=False, **cfg_kw)
    rx = Receiver(cfg, device=device)
    spent: dict = {}
    _timed(rx, ("_upload", "_run_acquisition", "_dispatch_tracking",
                "_finish_tracking", "_consume_tracking", "_run_observables"),
           spent)
    correlator.launches = 0
    tk.launches = tk.kf_launches = 0
    rx.run_source(ArraySignalSource(x, fs))
    if device.type == "cuda":
        torch.cuda.synchronize()
    k1, k2 = correlator.launches, tk.launches
    wall = time.perf_counter() - t0
    dur = len(x) / fs
    g = rx.groups[0]
    tracked = sorted(rx.tracked_prns())
    _line(phase, t0, step="receiver", wall_s=f"{wall:.3f}",
          realtime_x=f"{dur / wall:.3f}", stream_s=f"{dur:.3f}",
          tracked=tracked, scenario=sorted(sc.prns),
          steps_per_chunk=g.trk_cfg.n_steps, n_max=g.trk_cfg.n_max,
          dispatches=rx.tracking_dispatches, scan_steps=rx.scan_steps,
          k2_launches=k2, k2_kf_launches=tk.kf_launches, k1_launches=k1)
    _breakdown(phase, t0, spent, rx)
    if device.type == "cuda" and not (k2 == rx.tracking_dispatches > 0
                                      and k1 == 0):
        raise SystemExit(f"{phase}: K2 launches {k2} != dispatches "
                         f"{rx.tracking_dispatches}, or K1 launched {k1} "
                         f"times")
    return dict(rx=rx, k2_launches=k2, k2_kf_launches=tk.kf_launches,
                k1_launches=k1, wall_s=wall, tracked=tracked, t0=t0)


def _eph_mismatch(rx, sc, tol: float) -> list:
    """The PRNs whose decoded ephemeris misses the truth: a Kepler one by
    sqrt_a within ``tol`` and toe exact; a GLONASS state vector (its truth
    keyed ("R", prn)) by tb exact, position within 1 m and velocity within
    1e-2 m/s (tests/test_e2e_glonass.py)."""
    bad = []
    for (system, prn), e in rx.ephemerides.items():
        if system == "R":
            t = sc.ephemerides[("R", prn)]
            ok = (e.tb_s == t.tb_s
                  and np.allclose(e.pos_m, t.pos_m, rtol=0, atol=1.0)
                  and np.allclose(e.vel_m_s, t.vel_m_s, rtol=0, atol=1e-2))
        else:
            t = sc.ephemerides[prn]
            ok = abs(e.sqrt_a - t.sqrt_a) < tol and e.toe == t.toe
        if not ok:
            bad.append(prn)
    return bad


def _dyn_checks(rx, sc) -> dict:
    """tests/test_e2e_dynamic.py's readings of a moving receiver's fixes."""
    fixes = rx.fixes
    pos = [np.linalg.norm(f.pos_ecef - sc.rcv_pos_at(f.tow_s - sc.t0_gps))
           for f in fixes]
    vel = [np.linalg.norm(f.vel_ecef - sc.rcv_vel_ecef) for f in fixes]
    return dict(fixes=len(fixes),
                pos_rmse=float(np.sqrt(np.mean(np.square(pos))))
                if fixes else float("inf"),
                vel_rmse=float(np.sqrt(np.mean(np.square(vel))))
                if fixes else float("inf"))


def phase_dynamic(device, duration_s: float, check: bool) -> dict:
    """tests/test_e2e_dynamic.py on the card: a receiver moving at
    (12, -5, 0) m/s ENU through a 28 s, 6-satellite, 47 dB-Hz GPS L1 C/A
    scenario at 2 MSps (seed 41), 6 channels. Its three tests' checks: the
    3D position RMSE of every fix against the truth trajectory < 10 m, the
    3D velocity RMSE < 5 m/s, the mean speed of the last 5 fixes within
    2 m/s of the truth, and the first-to-last fix displacement within 25 %
    (or 5 m) of |v| dt; every satellite tracked."""
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    sc = scenario.build_gps_l1_scenario(duration_s=duration_s, n_sats=6,
                                        cn0_dbhz=47.0, fs=FS,
                                        vel_enu=DYN_VEL_ENU)
    x = sc.generate(seed=41, device=device)
    _line("dynamic", t0, step="generate", samples=len(x),
          prns=sorted(sc.prns), speed_m_s=float(np.linalg.norm(
              sc.rcv_vel_ecef)))
    run = _receiver_run(device, "dynamic", sc, x, FS, signal="1C",
                        n_channels=6, acq_doppler_max_hz=5000.0,
                        acq_doppler_step_hz=250.0)
    rx = run["rx"]
    bad = []
    if check:
        fixes = rx.fixes
        if len(fixes) < 5:
            raise SystemExit(f"dynamic: only {len(fixes)} fixes")
        got = _dyn_checks(rx, sc)
        pos_rmse, vel_rmse = got["pos_rmse"], got["vel_rmse"]
        v_true = float(np.linalg.norm(sc.rcv_vel_ecef))
        speed = float(np.mean([np.linalg.norm(f.vel_ecef)
                               for f in fixes[-5:]]))
        dt = fixes[-1].tow_s - fixes[0].tow_s
        moved = float(np.linalg.norm(fixes[-1].pos_ecef - fixes[0].pos_ecef))
        expect = v_true * dt
        _line("dynamic", run["t0"], step="checks", fixes=len(fixes),
              pos_rmse_m=f"{pos_rmse:.3f}", vel_rmse_m_s=f"{vel_rmse:.3f}",
              last5_speed_m_s=f"{speed:.3f}", true_speed_m_s=f"{v_true:.3f}",
              moved_m=f"{moved:.3f}", expected_m=f"{expect:.3f}",
              fix_span_s=f"{dt:.3f}")
        for name, ok in (
                ("tracked", run["tracked"] == sorted(sc.prns)),
                ("position RMSE", pos_rmse < 10.0),
                ("velocity RMSE", vel_rmse < 5.0),
                ("speed", abs(speed - v_true) <= 2.0),
                ("motion", dt > 2.0
                 and abs(moved - expect) <= max(0.25 * expect, 5.0))):
            if not ok:
                bad.append(name)
    if bad:
        raise SystemExit(f"dynamic phase failed its checks: {bad}")
    return dict(run, sc=sc, x=x)


# tests/test_tracking.py's Doppler ramp for the Kalman carrier loop: PRN 5
# at -300 Hz and 60 Hz/s, 44 dB-Hz, 1.5 s at 2.5 MSps, 50 ms chunks
KF_RAMP = dict(prn=5, fd0=-300.0, rate=60.0, delay_s=0.00025, fs=2.5e6,
               duration_s=1.5, cn0_dbhz=44.0, seed=41)


def phase_kf(device, dyn: dict, check: bool, cli: bool = True) -> dict:
    """The Kalman carrier loop (``carrier_kf``; K2's KF variants on the card):
    (1) tests/test_tracking.py's Doppler ramp (KF_RAMP) through
    track_chunk_packed, one dispatch per 50 ms chunk on the packed carry:
    no loss of lock, the final carrier within 5 Hz of the ramp, the KF's
    rate state within 20 Hz/s of 60, the last carrier lock > 0.85; (2) the
    dynamic phase's receiver, on its capture, with ``carrier_kf``: every
    satellite tracked, >= 4 ephemerides, the dynamic budget (position RMSE
    < 10 m, velocity RMSE < 5 m/s), one KF launch per dispatch; K2 case (s)
    on its final carry, bit for bit; (3) conf/gps_l1_file.conf through the
    CLI with Tracking_1C.implementation=GPS_L1_CA_KF_Tracking on the first
    ``KF_CLI_S`` of that capture (``cli``): exit 0, every PRN tracking, one
    KF launch per dispatch."""
    from gnss_sdr_tpu_torch import constants
    from gnss_sdr_tpu_torch.models import codes
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tracking as trk
    from gnss_sdr_tpu_torch.utils import generator

    # (1) the ramp
    t0 = time.perf_counter()
    r = KF_RAMP
    spec = constants.GPS_L1_CA
    x = generator.generate(
        spec, [generator.SatParams(prn=r["prn"], cn0_dbhz=r["cn0_dbhz"],
                                   doppler_hz=r["fd0"],
                                   doppler_rate_hz_s=r["rate"],
                                   code_delay_s=r["delay_s"])],
        r["fs"], r["duration_s"], seed=r["seed"], device=device)
    xs = torch.from_numpy(np.stack([x.real, x.imag], -1).astype(
        np.float32)).to(device)
    cfg = trk.default_config(spec, r["fs"], 50, carrier_kf=True)
    st = trk.start_channel(
        trk.init_state(1, cfg.n_taps, device=device), 0,
        code_freq=1.023e6 * (1 + r["fd0"] / spec.carrier_freq_hz),
        doppler_hz=r["fd0"] + 30.0,
        sample_offset=int(round(r["delay_s"] * r["fs"])))
    carry = tk.pack_carry(st) if device.type == "cuda" else st
    table = torch.from_numpy(codes.code_chips("1C", r["prn"])[None].astype(
        np.float32)).to(device)
    n_chunks = int((len(x) - cfg.n_max) // cfg.chunk_len)
    before = tk.kf_launches
    rows = None
    for k in range(n_chunks):
        part = xs[k * cfg.chunk_len: (k + 1) * cfg.chunk_len + cfg.n_max]
        carry, rows = trk.track_chunk_packed(cfg, part, carry, table)
    if device.type == "cuda":
        torch.cuda.synchronize()
    end = trk.state_to_numpy(carry)
    f32p, i32p, lol = trk.unpack_host_outputs(rows.cpu().numpy())
    valid = f32p[:, 0, 8] > 0.5
    fd_final = r["fd0"] + r["rate"] * (int(end.epoch_count[0]) * 1e-3)
    ramp = dict(carrier_err_hz=float(end.carrier_freq[0]) - fd_final,
                kf_acc_hz_s=float(end.kf_acc[0]),
                last_lock=float(f32p[:, 0, 7][valid][-1]),
                loss=bool(end.loss_of_lock[0]))
    kf_ramp = tk.kf_launches - before
    _line("kf", t0, step="ramp", dispatches=n_chunks, kf_launches=kf_ramp,
          **{k: (f"{v:.4f}" if isinstance(v, float) else v)
             for k, v in ramp.items()})
    bad = [name for name, ok in (
        ("ramp lock", not ramp["loss"]),
        ("ramp carrier", abs(ramp["carrier_err_hz"]) < 5.0),
        ("ramp rate", abs(ramp["kf_acc_hz_s"] - r["rate"]) < 20.0),
        ("ramp carrier lock", ramp["last_lock"] > 0.85),
        ("ramp launches", device.type != "cuda" or kf_ramp == n_chunks))
        if not ok and (check or name == "ramp launches")]

    # (2) the receiver with the KF on the dynamic capture
    sc, xd = dyn["sc"], dyn["x"]
    run = _receiver_run(device, "kf", sc, xd, FS, signal="1C", n_channels=6,
                        acq_doppler_max_hz=5000.0, acq_doppler_step_hz=250.0,
                        carrier_kf=True)
    rx = run["rx"]
    got = _dyn_checks(rx, sc)
    wrong = _eph_mismatch(rx, sc, 2.0 ** -19)
    _line("kf", run["t0"], step="checks", fixes=got["fixes"],
          pos_rmse_m=f"{got['pos_rmse']:.3f}",
          vel_rmse_m_s=f"{got['vel_rmse']:.3f}",
          ephemerides=len(rx.ephemerides), eph_mismatch=wrong,
          kf_launches=run["k2_kf_launches"],
          dispatches=rx.tracking_dispatches)
    if device.type == "cuda" and run["k2_kf_launches"] != \
            rx.tracking_dispatches:
        bad.append("receiver KF launches")
    if check:
        bad += [name for name, ok in (
            ("tracked", run["tracked"] == sorted(sc.prns)),
            ("ephemerides", len(rx.ephemerides) >= 4 and not wrong),
            ("position RMSE", got["pos_rmse"] < 10.0),
            ("velocity RMSE", got["vel_rmse"] < 5.0)) if not ok]
    k2_err = phase_k2_case("s_kf_dynamic_final_carry", device,
                           *_final_carry_case(rx, xd), bitwise_only=True)

    # (3) the KF tracking block through the CLI
    on_cli = _kf_cli(device, sc, xd, KF_CLI_S) if cli else dict(kf=None)
    if cli and device.type == "cuda" and not (
            on_cli["kf"] == on_cli["dispatches"] > 0):
        bad.append("CLI KF launches")
    if cli and not set(sc.prns) <= set(on_cli["tracked"]):
        bad.append("CLI tracked PRNs")
    if bad:
        raise SystemExit(f"kf phase failed its checks: {bad}")
    return dict(kf_launches=run["k2_kf_launches"], ramp_kf_launches=kf_ramp,
                cli_kf_launches=on_cli["kf"], k2_err=k2_err)


KF_CLI_S = 8.0


def _kf_cli(device, sc, x: np.ndarray, seconds: float) -> dict:
    """conf/gps_l1_file.conf at 2 MSps with the KF tracking block, through
    the CLI on the first ``seconds`` of ``x``, in a temporary directory."""
    platform = "cuda" if device.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        _write_ishort(tmp / "capture.ishort", x[: int(seconds * FS)])
        conf = tmp / "rx.conf"
        conf.write_text(_conf_from_shipped(tmp / "capture.ishort", {
            "SignalSource.sampling_frequency": int(FS),
            "Tracking_1C.implementation": "GPS_L1_CA_KF_Tracking",
            "PVT.trop_model": "OFF", "PVT.iono_model": "OFF"}))
        t1 = time.perf_counter()
        stdout, stderr = _run_cli(conf, platform)
        cli_s = time.perf_counter() - t1
        got = _summary(stdout)
        _line("cli", t0, run="kf", seconds_of_capture=seconds,
              cli_seconds=f"{cli_s:.3f}", tracked=got["tracked"],
              scenario=sorted(sc.prns), tracking_dispatches=got["dispatches"],
              k2_launches=got["k2"], k2_kf_launches=got["kf"],
              k1_launches=got["k1"],
              device_line=f"device: {platform}" in stderr)
        if f"device: {platform}" not in stderr or got["k1"] != 0:
            raise SystemExit("the KF CLI run failed its checks")
    return got


# tests/test_e2e_sbas.py's scenario: 5 GPS satellites and SBAS PRN 123,
# 30 s at 2 MSps, 6 channels, carrier smoothing 25, the broadcast clock
# errors from default_rng(17), seed 23
SBAS_PRN, SBAS_DUR, SBAS_SEED = 123, 30.0, 23


def sbas_capture(device, duration_s: float) -> dict:
    """tests/test_e2e_sbas.py's capture: the broadcast LNAV clocks off by
    4-9e-8 s, and an SBAS channel whose MT1 mask and MT25 long-term
    corrections cancel the errors."""
    from gnss_sdr_tpu_torch.models.nav import sbas
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    base = scenario.build_gps_l1_scenario(duration_s=duration_s, n_sats=5,
                                          cn0_dbhz=47.0, fs=FS)
    prns = base.prns
    daf0_err = {p: float(rng.uniform(4e-8, 9e-8)) * (1 if i % 2 else -1)
                for i, p in enumerate(prns)}
    bad = {p: dataclasses.replace(base.ephemerides[p],
                                  af0=base.ephemerides[p].af0 + daf0_err[p])
           for p in prns}
    mask_bits = np.zeros(212, np.uint8)
    for p in prns:
        mask_bits[p - 1] = 1
    slots = {p: k + 1 for k, p in enumerate(sorted(prns))}
    lt = [sbas.LongTermCorrection(mask_no=slots[p], iode=0,
                                  dpos=(0.0, 0.0, 0.0), daf0=-daf0_err[p])
          for p in sorted(prns)]
    halves = [sbas.encode_type25_half(lt[k], lt[k + 1] if k + 1 < len(lt)
                                      else None)
              for k in range(0, len(lt), 2)]
    halves += [np.zeros(106, np.uint8)] * (len(halves) % 2)
    msgs = [(1, mask_bits)] + [
        (25, sbas.encode_type25(halves[k], halves[k + 1]))
        for k in range(0, len(halves), 2)]
    sc = scenario.build_gps_l1_scenario(
        duration_s=duration_s, n_sats=5, cn0_dbhz=47.0, fs=FS,
        broadcast_ephemerides=bad, sbas_prn=SBAS_PRN, sbas_messages=msgs)
    x = sc.generate(seed=SBAS_SEED, device=device)
    _line("sbas", t0, step="generate", samples=len(x), prns=sorted(prns),
          sbas_prn=SBAS_PRN, messages=[m for m, _ in msgs])
    return dict(sc=sc, x=x, daf0_err=daf0_err)


def phase_sbas(device, cap: dict, check: bool) -> dict:
    """tests/test_e2e_sbas.py on the card: the receiver with the SBAS
    corrections off and on (6 channels, the scenario's PRNs and 123,
    carrier smoothing 25). Its checks: PRN 123 tracked, >= 3 messages, the
    MT1 mask equal to the sorted PRNs, every MT25 daf0 within 2^-31 of
    minus the injected error, >= 3 fixes each, and the 3D error of the mean
    of the last 40 fixes e_off > 4 m, e_on < 3.5 m, e_on < e_off / 3; one
    K2 launch per dispatch."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy

    sc, x, errs = cap["sc"], cap["x"], cap["daf0_err"]
    lat, lon, _ = sc.rcv_llh

    def err3d(rx):
        if not rx.fixes:
            return float("inf")
        enu = np.stack([geodesy.ecef_to_enu(f.pos_ecef - sc.rcv_ecef, lat,
                                            lon)
                        for f in rx.fixes[-40:]]).mean(axis=0)
        return float(np.linalg.norm(enu))

    runs = {}
    for apply in (False, True):
        run = _receiver_run(device, "sbas", sc, x, FS, signal="1C",
                            n_channels=6,
                            prns=tuple(list(sc.prns) + [SBAS_PRN]),
                            carrier_smoothing_factor=25,
                            pvt_apply_sbas=apply)
        runs[apply] = run
    rx = runs[True]["rx"]
    tlm = next((ch.telemetry for g in rx.groups for ch in g.channels
                if ch.prn == SBAS_PRN), None)
    e_off, e_on = err3d(runs[False]["rx"]), err3d(rx)
    lt_err = max((abs(tlm.long_term[sorted(sc.prns).index(p) + 1].daf0
                      + errs[p]) if tlm is not None and
                  sorted(sc.prns).index(p) + 1 in tlm.long_term
                  else float("inf")) for p in sc.prns)
    msgs = tlm.message_count if tlm is not None else 0
    _line("sbas", runs[True]["t0"], step="checks",
          tracked=runs[True]["tracked"], messages=msgs,
          mask=tlm.prn_mask if tlm is not None else None,
          long_term=len(tlm.long_term) if tlm is not None else 0,
          worst_daf0_err_s=f"{lt_err:.3e}",
          fixes_off=len(runs[False]["rx"].fixes), fixes_on=len(rx.fixes),
          e_off_m=f"{e_off:.3f}", e_on_m=f"{e_on:.3f}")
    bad = []
    if check:
        bad = [name for name, ok in (
            ("tracked", SBAS_PRN in runs[True]["tracked"]),
            ("messages", msgs >= 3),
            ("mask", tlm is not None and tlm.prn_mask == sorted(sc.prns)),
            ("long-term", lt_err <= 2.0 ** -31),
            ("fixes", len(rx.fixes) >= 3
             and len(runs[False]["rx"].fixes) >= 3),
            ("degraded", e_off > 4.0), ("corrected", e_on < 3.5),
            ("ratio", e_on < e_off / 3.0)) if not ok]
    if bad:
        raise SystemExit(f"sbas phase failed its checks: {bad}")
    return dict(k2_launches=runs[True]["k2_launches"],
                k1_launches=runs[True]["k1_launches"],
                dispatches=rx.tracking_dispatches)


# tests/test_e2e_l2c.py's, tests/test_e2e_beidou.py's,
# tests/test_e2e_glonass{,_l2}.py's and tests/test_e2e_beidou_b3.py's
# scenarios, receiver settings and checks: (scenario function, its
# arguments, seed, receiver settings, sqrt_a tolerance, least ephemerides,
# fixes averaged, least fixes, 2D and 3D limits in m, the last fix's PDOP
# limit or None; the 511.5 / 511 kcps chips of L2C and GLONASS are 586 m,
# hence their budgets). The GLONASS scenarios set their own duration.
SIGNAL_RUNS = {
    "l2c": ("build_gps_l2c_scenario",
            dict(n_sats=5, cn0_dbhz=45.0, fs=L2C_FS), 77,
            dict(signal="2S", n_channels=5, acq_doppler_max_hz=4000.0,
                 acq_doppler_step_hz=25.0, pll_bw_hz=12.0, dll_bw_hz=0.75,
                 fll_bw_hz=5.0, pll_bw_narrow_hz=8.0, dll_bw_narrow_hz=0.5),
            1e-3, 5, 20, 5, 10.0, 20.0, None),
    "b1i": ("build_beidou_b1i_scenario",
            dict(n_sats=4, cn0_dbhz=48.0, fs=B1I_FS), 91,
            dict(signal="B1", n_channels=4, acq_doppler_max_hz=5000.0,
                 acq_doppler_step_hz=250.0),
            1e-4, 4, 5, 3, 2.0, 5.0, None),
    "glo_l1": ("build_glonass_l1_scenario",
               dict(n_sats=5, cn0_dbhz=48.0, fs=GLO1_FS), 97,
               dict(signal="1G", n_channels=5, acq_doppler_max_hz=5000.0,
                    acq_doppler_step_hz=250.0, carrier_smoothing_factor=100),
               None, 5, 20, 10, 10.0, 20.0, 6.0),
    "glo_l2": ("build_glonass_l1_scenario",
               dict(n_sats=4, cn0_dbhz=48.0, fs=GLO2_FS, band="2G"), 96,
               dict(signal="2G", n_channels=4, acq_doppler_max_hz=5000.0,
                    acq_doppler_step_hz=250.0, carrier_smoothing_factor=100),
               None, 4, 20, 10, 10.0, 20.0, None),
    "b3i": ("build_beidou_b1i_scenario",
            dict(n_sats=4, cn0_dbhz=48.0, fs=B3I_FS, band="B3"), 88,
            dict(signal="B3", n_channels=4, acq_doppler_max_hz=5000.0,
                 acq_doppler_step_hz=250.0),
            1e-3, 4, 10, 5, 2.0, 5.0, None),
}


def phase_signal(name: str, device, duration_s: float | None,
                 check: bool) -> dict:
    """``l2c``: tests/test_e2e_l2c.py on the card, 5 GPS L2 CM satellites
    with CNAV (58 s at 2 MSps, 45 dB-Hz, seed 77), 5 channels, that test's
    loop bandwidths; ``b1i``: tests/test_e2e_beidou.py, 4 BeiDou B1I MEO /
    IGSO satellites with D1 under NH20 (30 s at 4 MSps, 48 dB-Hz, seed 91),
    4 channels; ``glo_l1`` / ``glo_l2``: tests/test_e2e_glonass{,_l2}.py, 5
    / 4 GLONASS satellites, each at its FDMA slot's IF, with GNAV (the
    scenario's own duration at 8 / 6 MSps, 48 dB-Hz, seed 97 / 96), 5 / 4
    channels, carrier smoothing 100; ``b3i``: tests/test_e2e_beidou_b3.py,
    4 BeiDou B3I MEO / IGSO satellites (30 s at 12 MSps, seed 88), 4
    channels. Every satellite tracked, at least the JAX test's number of
    ephemerides equal to the truth (``_eph_mismatch``), and at least its
    number of fixes whose last 20 / 5 / 20 / 10 average within 2D < 10 m /
    3D < 20 m (L2C, GLONASS) or 2D < 2 m / 3D < 5 m (B1I, B3I); GLONASS L1's
    last fix at PDOP < 6. ``duration_s`` None: the scenario's own."""
    from gnss_sdr_tpu_torch.utils import scenario

    (make, kw, seed, rx_kw, tol, n_eph, n_avg, n_fix, lim_2d,
     lim_3d, pdop) = SIGNAL_RUNS[name]
    t0 = time.perf_counter()
    if make == "build_glonass_l1_scenario":
        sc = getattr(scenario, make)(**kw)
        if duration_s is not None:
            sc.duration_s = duration_s
    else:
        sc = getattr(scenario, make)(duration_s=duration_s, **kw)
    x = sc.generate(seed=seed, device=device)
    _line(name, t0, step="generate", samples=len(x), prns=sorted(sc.prns),
          stream_s=f"{sc.duration_s:.3f}")
    run = _receiver_run(device, name, sc, x, kw["fs"], **rx_kw)
    if check:
        rx = run["rx"]
        wrong = _eph_mismatch(rx, sc, tol)
        err = (_fix_error(rx.fixes[-n_avg:], sc) if len(rx.fixes) >= n_fix
               else (np.inf, np.inf))
        last_pdop = rx.fixes[-1].pdop if rx.fixes else np.inf
        _line(name, run["t0"], step="checks",
              ephemerides=len(rx.ephemerides), eph_mismatch=wrong,
              fixes=len(rx.fixes), err_2d_m=f"{err[0]:.3f}",
              err_3d_m=f"{err[1]:.3f}", last_pdop=f"{last_pdop:.3f}")
        bad = [what for what, ok in (
            ("tracked", run["tracked"] == sorted(sc.prns)),
            ("ephemerides", len(rx.ephemerides) >= n_eph and not wrong),
            ("fix", err[0] < lim_2d and err[1] < lim_3d),
            ("pdop", pdop is None or last_pdop < pdop)) if not ok]
        if bad:
            raise SystemExit(f"{name} phase failed its checks: {bad}")
    return dict(run, sc=sc, x=x)


# the GLONASS CLI captures: (band, satellites, seed). The C/A code is one
# for every slot, so a PRN and its antipodal twin on the same FDMA slot
# (PRN +- 4 in the slot map) are one signal to the receiver, and the shipped
# confs search all 24 PRNs: each capture holds as many satellites as leave
# a channel for every twin (3 on L1's 6 channels, 2 on L2's 5), so every
# satellite of the capture is tracked whatever order its twins acquire in
GLO_CLI = {"glonass_l1.conf": ("1G", 3, 97), "glonass_l2.conf": ("2G", 2, 96)}


def glonass_cli_capture(device, conf_name: str, fs: float,
                        seconds: float) -> dict:
    """``seconds`` of tests/test_e2e_glonass{,_l2}.py's scenario (48 dB-Hz)
    at the conf's rate ``fs`` with GLO_CLI's satellites."""
    from gnss_sdr_tpu_torch.utils import scenario

    band, n_sats, seed = GLO_CLI[conf_name]
    t0 = time.perf_counter()
    sc = scenario.build_glonass_l1_scenario(n_sats=n_sats, cn0_dbhz=48.0,
                                            fs=fs, band=band)
    sc.duration_s = seconds
    x = sc.generate(seed=seed, device=device)
    _line("cli", t0, step="generate", run=conf_name.split(".")[0], fs=fs,
          samples=len(x), prns=sorted(sc.prns))
    return dict(sc=sc, x=x)


def phase_cli_shipped(device, run: dict, conf_name: str, fs: float,
                      seconds: float) -> int:
    """The shipped ``conf_name`` run by the CLI on the first ``seconds`` of
    a phase's capture written as ishort (its capture path and item type
    replaced, PVT.trop_model / iono_model OFF, ``--max_chunks``): exit 0, a
    device line naming the platform, every scenario PRN tracking, one K2
    launch per dispatch and no K1 launch. Returns the CLI's K2 launches."""
    platform = "cuda" if device.type == "cuda" else "cpu"
    sc = run["sc"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        _write_ishort(tmp / "capture.ishort", run["x"][: int(seconds * fs)])
        lines = []
        for ln in (ROOT / "conf" / conf_name).read_text().splitlines():
            if ln.startswith("SignalSource.filename="):
                ln = f"SignalSource.filename={tmp / 'capture.ishort'}"
            elif ln.startswith("SignalSource.item_type="):
                ln = "SignalSource.item_type=ishort"
            lines.append(ln)
        lines += ["PVT.trop_model=OFF", "PVT.iono_model=OFF"]
        conf = tmp / "rx.conf"
        conf.write_text("\n".join(lines) + "\n")
        t1 = time.perf_counter()
        stdout, stderr = _run_cli(conf, platform, "--max_chunks",
                                  str(int(seconds * 10)))
        cli_s = time.perf_counter() - t1
        got = _summary(stdout)
        _line("cli", t0, run=conf_name.split(".")[0],
              seconds_of_capture=seconds, cli_seconds=f"{cli_s:.3f}",
              tracked=got["tracked"],
              scenario=sorted(sc.prns), tracking_dispatches=got["dispatches"],
              k2_launches=got["k2"], k1_launches=got["k1"],
              device_line=f"device: {platform}" in stderr)
        bad = [name for name, ok in (
            ("device line", f"device: {platform}" in stderr),
            ("tracked PRNs", set(sc.prns) <= set(got["tracked"])),
            ("K1 launches", got["k1"] == 0),
            ("K2 launches", device.type != "cuda"
             or got["k2"] == got["dispatches"] > 0)) if not ok]
        if bad:
            raise SystemExit(f"{conf_name} CLI run failed its checks: {bad}")
    return got["k2"]


# tests/test_e2e_rtk.py's capture (the multisource L1 scenario: 42 s, 6
# satellites, 47 dB-Hz, 2 MSps, seed 101) and its synthetic base: 3 km
# east of the truth, integer ambiguities from default_rng(71), one MSM7
# epoch per 25th observable epoch; the NTRIP run streams the last 20 of
# them (what RtcmBaseStation keeps)
RTK_T0, RTK_DUR, RTK_SEED = 352800.08, 42.0, 101
RTK_BASE_ENU = (3000.0, -800.0, 5.0)
RTK_CLI_EPOCHS = 20


def _rtk_base_msm(sc, base_ecef, obs, rng, n_bas) -> tuple:
    """tests/test_e2e_rtk.py's base epoch for one rover epoch: the base's
    observations of the rover's PRNs at the rover epoch's millisecond-
    aligned tow (code noise 0.3 m, phase noise 5 mm); (tow, MSM7 frame)."""
    from gnss_sdr_tpu_torch import constants as C
    from gnss_sdr_tpu_torch.receiver.pvt import rtcm
    from gnss_sdr_tpu_torch.utils import constellation

    lam = C.SPEED_OF_LIGHT_M_S / 1_575_420_000.0
    o0 = obs[0]
    tow = round((o0.t_tx_sv + o0.pseudorange_m / C.SPEED_OF_LIGHT_M_S)
                * 1e3) / 1e3
    msm = []
    for o in obs:
        bo = constellation.simulate_observation(sc.ephemerides[o.prn],
                                                base_ecef, tow)
        msm.append(rtcm.MsmObservation(
            prn=o.prn, signal_id=2,
            pseudorange_m=bo.pseudorange_m + rng.normal(0, 0.3),
            phase_range_m=(bo.pseudorange_m + n_bas[o.prn] * lam
                           + rng.normal(0, 0.005) * lam),
            phase_rate_m_s=-bo.doppler_hz * lam, cn0_dbhz=45.0))
    return tow, rtcm.frame(rtcm.encode_msm7(rtcm.MSM7_GPS, 55,
                                            int(round(tow * 1e3)), msm))


def _rtk_dd_fractions(sc, rx, base_ecef, epochs=(600, 1000, 1400)) -> list:
    """tests/test_e2e_rtk.py's double differences of the receiver's carrier
    phase against the geometric base at observable epochs ``epochs`` (five
    or more satellites): the fractional parts, in cycles."""
    from gnss_sdr_tpu_torch import constants as C
    from gnss_sdr_tpu_torch.utils import constellation

    c = C.SPEED_OF_LIGHT_M_S
    lam = c / 1_575_420_000.0
    om = 7.2921151467e-5

    def rho(p, r):
        th = om * np.linalg.norm(p - r) / c
        rot = np.array([[np.cos(th), np.sin(th), 0],
                        [-np.sin(th), np.cos(th), 0], [0, 0, 1]])
        return np.linalg.norm(rot @ p - r)

    fracs = []
    for k in epochs:
        if k >= len(rx.obs_log) or len(rx.obs_log[k][1]) < 5:
            continue
        obs = rx.obs_log[k][1]
        tow = round((obs[0].t_tx_sv + obs[0].pseudorange_m / c) * 1e3) / 1e3
        sd = {}
        for o in obs:
            eph = sc.ephemerides[o.prn]
            bo = constellation.simulate_observation(eph, base_ecef, tow)
            dts_r = eph.clock_offset(o.t_tx_sv)
            p_r, _ = eph.position_velocity(o.t_tx_sv - dts_r)
            dts_b = eph.clock_offset(bo.t_tx_sv)
            p_b, _ = eph.position_velocity(bo.t_tx_sv - dts_b)
            sdm = ((rho(p_r, sc.rcv_ecef) - c * dts_r)
                   - (rho(p_b, base_ecef) - c * dts_b))
            sd[o.prn] = (o.carrier_phase_cycles * lam - bo.pseudorange_m
                         - sdm) / lam
        ref = sorted(sd)[0]
        fracs += [abs((v - sd[ref] + 0.5) % 1.0 - 0.5)
                  for p, v in sd.items() if p != ref]
    return fracs


def phase_rtk(device, duration_s: float, check: bool, smi: str = "") -> dict:
    """tests/test_e2e_rtk.py on the card: the port's receiver (K2 on the
    card) tracks the 42 s capture, then the RTK rover runs on its
    observables against the synthetic base (1005 + 1019, then one MSM7
    epoch per 25th observable epoch) in RtkEngine(sigma_pr_m=2.5,
    mode="kinematic"). Its checks: >= 60 float epochs, the mean ENU error
    of the last 20 float baselines < 2 m, >= 3 fixed epochs, the median of
    the last 3 fixes < 2 m, and the double differences of the receiver's
    carrier phase at observable epochs 600 / 1000 / 1400 integer: >= 12
    checked, mean fractional part < 0.15 and worst < 0.45 cycles."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy, rtcm
    from gnss_sdr_tpu_torch.receiver.pvt.rtk_engine import (RtcmBaseStation,
                                                            RtkEngine)
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    sc = scenario.build_gps_l1_scenario(t0_gps=RTK_T0, duration_s=duration_s,
                                        n_sats=6, cn0_dbhz=47.0, fs=FS)
    x = sc.generate(seed=RTK_SEED, device=device)
    gen_s = time.perf_counter() - t0
    _line("rtk", t0, step="generate", samples=len(x), prns=sorted(sc.prns))
    run = _receiver_run(device, "rtk", sc, x, FS, signal="1C", n_channels=6)
    rx = run["rx"]

    t1 = time.perf_counter()
    lat, lon, _ = sc.rcv_llh
    base_ecef = sc.rcv_ecef + geodesy.enu_to_ecef_offset(
        np.array(RTK_BASE_ENU), lat, lon)
    rng = np.random.default_rng(71)
    n_bas = {p: int(rng.integers(-300, 300)) for p in sc.prns}
    head = b"".join([rtcm.frame(rtcm.encode_1005(55, base_ecef))]
                    + [rtcm.frame(rtcm.encode_1019(sc.ephemerides[p]))
                       for p in sc.prns])
    station = RtcmBaseStation()
    station.push_bytes(head)
    engine = RtkEngine(station, sigma_pr_m=2.5, mode="kinematic")
    fixed, float_enu, frames = [], [], []
    for k, (tick, obs) in enumerate(rx.obs_log):
        if k % 25 or len(obs) < 5:         # one RTK epoch per 0.5 s
            continue
        tow, frame = _rtk_base_msm(sc, base_ecef, obs, rng, n_bas)
        frames.append(frame)
        station.push_bytes(frame)
        engine.push_rover_epoch(tick, obs)
        if engine.solutions:
            sol = engine.solutions[-1]
            float_enu.append(geodesy.ecef_to_enu(
                sol.baseline_m + base_ecef - sc.rcv_ecef, lat, lon))
            if sol.fixed:
                fixed.append(sol.rover_ecef.copy())
    engine_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    fracs = _rtk_dd_fractions(sc, rx, base_ecef)
    dd_s = time.perf_counter() - t2
    late = (float(np.linalg.norm(np.stack(float_enu[-20:]).mean(axis=0)))
            if float_enu else float("inf"))
    med = (float(np.linalg.norm(np.median(np.stack([
        geodesy.ecef_to_enu(p - sc.rcv_ecef, lat, lon) for p in fixed[-3:]]),
        axis=0))) if fixed else float("inf"))
    mean_frac = float(np.mean(fracs)) if fracs else float("inf")
    worst = max(fracs, default=float("inf"))
    _line("rtk", t0, step="checks", float_epochs=len(float_enu),
          late_float_err_m=f"{late:.3f}", fixed_epochs=len(fixed),
          median_fix_err_m=f"{med:.3f}", dd_checked=len(fracs),
          dd_mean_frac_cyc=f"{mean_frac:.4f}", dd_worst_frac_cyc=f"{worst:.4f}",
          base_epochs=len(frames), k2_launches=run["k2_launches"],
          dispatches=rx.tracking_dispatches, generate_s=f"{gen_s:.3f}",
          receiver_s=f"{run['wall_s']:.3f}", engine_s=f"{engine_s:.3f}",
          dd_s=f"{dd_s:.3f}", card=f'"{smi}"')
    bad = []
    if check:
        bad = [name for name, ok in (
            ("tracked", run["tracked"] == sorted(sc.prns)),
            ("float epochs", len(float_enu) >= 60), ("float", late < 2.0),
            ("fixed epochs", len(fixed) >= 3), ("fixes", med < 2.0),
            ("dd checked", len(fracs) >= 12), ("dd mean", mean_frac < 0.15),
            ("dd worst", worst < 0.45)) if not ok]
    if bad:
        raise SystemExit(f"rtk phase failed its checks: {bad}")
    return dict(sc=sc, x=x, head=head, frames=frames,
                k2_launches=run["k2_launches"],
                k1_launches=run["k1_launches"])


def _gga_enu(nmea: str, sc) -> np.ndarray:
    """The ENU offsets from the scenario's truth of the fixes in an NMEA
    file's GGA sentences, [N, 3] in metres."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy

    out = []
    for ln in nmea.splitlines():
        f = ln.split(",")
        if not ln.startswith("$GPGGA") or len(f) < 10 or not f[2]:
            continue
        lat = (int(f[2][:2]) + float(f[2][2:]) / 60.0) * (
            1 if f[3] == "N" else -1)
        lon = (int(f[4][:3]) + float(f[4][3:]) / 60.0) * (
            1 if f[5] == "E" else -1)
        pos = geodesy.geodetic_to_ecef(np.deg2rad(lat), np.deg2rad(lon),
                                       float(f[9]))
        out.append(geodesy.ecef_to_enu(pos - sc.rcv_ecef, *sc.rcv_llh[:2]))
    return np.array(out).reshape(-1, 3)


class _NtripCaster:
    """A one-client NTRIP v1 caster thread on 127.0.0.1 (a free port): it
    reads the request, checks the mountpoint and the Basic credentials,
    answers ``ICY 200 OK`` and ``payload`` (else the sourcetable), and holds
    the connection until the client closes it. ``close`` joins the thread
    and closes every socket."""

    def __init__(self, mount: str, user: str, password: str, payload: bytes):
        import base64
        import socket
        import threading

        self.want = (f"GET /{mount} ".encode(),
                     "Authorization: Basic {}".format(base64.b64encode(
                         f"{user}:{password}".encode()).decode()).encode())
        self.payload = payload
        self.request, self.sent, self.error = b"", 0, None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self._srv.settimeout(240.0)
        self.port = self._srv.getsockname()[1]
        self._conn = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        try:
            self._conn, _ = self._srv.accept()
            self._conn.settimeout(240.0)
            while b"\r\n\r\n" not in self.request:
                data = self._conn.recv(4096)
                if not data:
                    return
                self.request += data
            if all(w in self.request for w in self.want):
                self._conn.sendall(b"ICY 200 OK\r\n" + self.payload)
                self.sent = len(self.payload)
            else:
                self._conn.sendall(b"SOURCETABLE 200 OK\r\n\r\n")
                return
            while self._conn.recv(4096):       # until the client closes
                pass
        except OSError as e:                   # timeout or reset
            self.error = repr(e)

    def close(self) -> None:
        for s in (self._conn, self._srv):
            if s is not None:
                s.close()
        self._thread.join(timeout=10.0)


def phase_cli_rtk(device, rtk: dict, check: bool) -> int:
    """conf/rtk_rover_ntrip.conf through the CLI on the rtk phase's capture
    written as ishort: its capture path and rate (2 MSps) replaced,
    PVT.trop_model / iono_model OFF (the simulation has no atmosphere),
    PVT.rtk_base_address / _port at a caster thread (_NtripCaster) that
    checks the request's mountpoint BASE1 and the conf's credentials and
    streams 1005 + 1019 and the base's last RTK_CLI_EPOCHS MSM7 epochs.
    Checks: the caster saw the request and delivered the stream, the CLI
    logged its RTK rover mode line, exited 0, its RTK engine produced
    solutions, and the mean of its last 10 fixes (its NMEA GGA sentences)
    lies within 2D < 2 m / 3D < 5 m. Returns the CLI's K2 launches."""
    platform = "cuda" if device.type == "cuda" else "cpu"
    sc = rtk["sc"]
    payload = rtk["head"] + b"".join(rtk["frames"][-RTK_CLI_EPOCHS:])
    conf_text = (ROOT / "conf" / "rtk_rover_ntrip.conf").read_text()
    keys = dict(line.split("=", 1) for line in conf_text.splitlines()
                if line.startswith("PVT.rtk_ntrip_"))
    caster = _NtripCaster(keys["PVT.rtk_ntrip_mountpoint"],
                          keys["PVT.rtk_ntrip_user"],
                          keys["PVT.rtk_ntrip_password"], payload)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            t0 = time.perf_counter()
            _write_ishort(tmp / "capture.ishort", rtk["x"])
            lines = []
            for ln in conf_text.splitlines():
                if ln.startswith("SignalSource.filename="):
                    ln = f"SignalSource.filename={tmp / 'capture.ishort'}"
                elif ln.startswith("SignalSource.sampling_frequency="):
                    ln = f"SignalSource.sampling_frequency={int(FS)}"
                elif ln.startswith("PVT.rtk_base_address="):
                    ln = "PVT.rtk_base_address=127.0.0.1"
                elif ln.startswith("PVT.rtk_base_port="):
                    ln = f"PVT.rtk_base_port={caster.port}"
                lines.append(ln)
            lines += ["PVT.trop_model=OFF", "PVT.iono_model=OFF",
                      f"PVT.nmea_dump_filename={tmp / 'fix.nmea'}"]
            conf = tmp / "rx.conf"
            conf.write_text("\n".join(lines) + "\n")
            write_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            stdout, stderr = _run_cli(conf, platform)
            cli_s = time.perf_counter() - t1
            gga = _gga_enu((tmp / "fix.nmea").read_text(), sc)
    finally:
        caster.close()
    got = _summary(stdout)
    err = _cli_fix_error(got, sc)
    mean10 = gga[-10:].mean(axis=0) if len(gga) else np.full(3, np.inf)
    last10 = (float(np.linalg.norm(mean10[:2])), float(np.linalg.norm(mean10)))
    m = re.search(r"rtk solutions: (\d+) \((\d+) fixed\)", stdout)
    n_sol, n_fix = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
    mode_line = "RTK rover mode (kinematic): base 127.0.0.1" in stderr
    _line("cli_rtk", t0, write_s=f"{write_s:.3f}", cli_seconds=f"{cli_s:.3f}",
          request=caster.request.split(b"\r\n")[0].decode(errors="replace"),
          sent_bytes=caster.sent, payload_bytes=len(payload),
          base_epochs=min(len(rtk["frames"]), RTK_CLI_EPOCHS),
          mode_line=mode_line, rtk_solutions=n_sol, rtk_fixed=n_fix,
          tracked=got["tracked"], tracking_dispatches=got["dispatches"],
          k2_launches=got["k2"], k1_launches=got["k1"],
          caster_error=caster.error, fixes=len(gga),
          last10_err_2d_m=f"{last10[0]:.3f}",
          last10_err_3d_m=f"{last10[1]:.3f}",
          **{f"last_fix_{k}": f"{v:.3f}" for k, v in err.items()})
    bad = [name for name, ok in (
        ("device line", f"device: {platform}" in stderr),
        ("request", caster.request.startswith(b"GET /BASE1 ")),
        ("stream delivered", caster.sent == len(payload)),
        ("mode line", mode_line),
        ("K1 launches", got["k1"] == 0),
        ("K2 launches", device.type != "cuda"
         or got["k2"] == got["dispatches"] > 0)) if not ok]
    if check:
        bad += [name for name, ok in (
            ("rtk solutions", n_sol > 0),
            ("tracked PRNs", set(sc.prns) <= set(got["tracked"])),
            ("fixes", len(gga) >= 10 and last10[0] < 2.0
             and last10[1] < 5.0)) if not ok]
    if bad:
        raise SystemExit(f"the RTK CLI run failed its checks: {bad}")
    return got["k2"]


# ------------------------------------ input conditioning, sources, SUPL ---
# tests/test_input_filter_chain.py's jammer: a CW tone 30x the noise
# amplitude at 0.31 MHz, on its 5-satellite, 47 dB-Hz, 4 s scenario (seed 3)
JAM_HZ, JAM_AMP = 0.31e6, 30.0
LABSAT_FS, LABSAT_DUR = 16.368e6, 5.0
SUPL_DUR = 14.0


def _jammer(n: int, fs: float = FS) -> np.ndarray:
    return (JAM_AMP * np.exp(2j * np.pi * JAM_HZ * np.arange(n) / fs)
            ).astype(np.complex64)


def _shipped_conf(conf_name: str, replace: dict, extra: dict) -> str:
    """``conf/<conf_name>`` with the lines of the keys in ``replace``
    replaced and the ``extra`` keys appended (a later line wins)."""
    lines = []
    for ln in (ROOT / "conf" / conf_name).read_text().splitlines():
        key = ln.split("=", 1)[0]
        lines.append(f"{key}={replace[key]}" if key in replace else ln)
    lines += [f"{k}={v}" for k, v in extra.items()]
    return "\n".join(lines) + "\n"


def _cli_checks(name: str, device, got: dict, stderr: str, bad: list,
                tracks: bool = True) -> None:
    """The checks every CLI run of the slice shares: the device line, K1
    never, K2 once per tracking dispatch on the card (and some dispatch,
    unless the run is one that ``tracks`` nothing: the jammed capture
    without its notch)."""
    platform = "cuda" if device.type == "cuda" else "cpu"
    bad = list(bad) + [label for label, ok in (
        ("device line", f"device: {platform}" in stderr),
        ("K1 launches", got["k1"] == 0),
        ("K2 launches", device.type != "cuda"
         or (got["k2"] == got["dispatches"]
             and (got["dispatches"] > 0 or not tracks)))) if not ok]
    if bad:
        raise SystemExit(f"the {name} CLI run failed its checks: {bad}")


def phase_conditioning(device, seconds: float = 0.1) -> None:
    """The input-conditioning ops on ``device`` against the same functions
    on the CPU, on ``seconds`` of a generated GPS L1 capture (5 satellites,
    47 dB-Hz, 2 MSps, seed 3): pulse_blanking (25x pulses on 2 % of the
    64-sample segments), notch_excision (the CW jammer), beamform (a
    4-element array: the capture plus unit noise per element, steered to
    20 degrees), freq_translate (0.25 MHz from sample 4e7) and
    direct_resample (2 of every 5 samples). Each output within |dy| <=
    1e-4 max|y| + 1e-5 of the CPU's (direct_resample exact), the notch's
    kept bins and the blanked segments equal; each op's time per 100 ms of
    samples, CUDA events over 50 calls after a warm-up."""
    from gnss_sdr_tpu_torch.ops import beamformer, fir, interference, iq
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    sc = scenario.build_gps_l1_scenario(duration_s=seconds, n_sats=5,
                                        cn0_dbhz=47.0, fs=FS)
    x = sc.generate(seed=3)
    n = len(x)
    rng = np.random.default_rng(5)
    pulsed = x.copy()
    for s in rng.choice(n // 64, size=n // 64 // 50, replace=False):
        pulsed[64 * s: 64 * s + 64] *= 25.0
    arr = np.stack([x + ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                         / np.sqrt(2.0)).astype(np.complex64)
                    for _ in range(4)])
    w2 = iq.split(beamformer.ula_steering_weights(4, np.deg2rad(20.0)))
    host = {"pulsed": iq.split(pulsed), "jammed": iq.split(x + _jammer(n)),
            "x": iq.split(x),
            "arr": np.stack([arr.real, arr.imag], -1).astype(np.float32),
            "w": w2}
    ops = {
        "pulse_blanking": (lambda t: interference.pulse_blanking(
            t["pulsed"], 10.0, 64), lambda t: interference.pulse_blank_mask(
                t["pulsed"], 10.0, 64)),
        "notch_excision": (lambda t: interference.notch_excision(
            t["jammed"], 12.0), lambda t: interference.notch_keep_mask(
                t["jammed"], 12.0)),
        "beamform": (lambda t: beamformer.beamform(t["arr"], t["w"]), None),
        "freq_translate": (lambda t: fir.freq_translate(
            t["x"], 0.25e6, FS, n0=40_000_000), None),
        "direct_resample": (lambda t: fir.direct_resample(
            t["x"], 2, 5, n * 2 // 5), None),
    }
    cpu = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    dev = {k: v.to(device) for k, v in cpu.items()}
    _line("conditioning", t0, step="inputs", samples=n, elements=4)
    for name, (op, mask) in ops.items():
        t0 = time.perf_counter()
        want, got = op(cpu).numpy(), op(dev).cpu().numpy()
        err = float(np.abs(got - want).max())
        tol = (0.0 if name == "direct_resample"
               else 1e-4 * float(np.abs(want).max()) + 1e-5)
        agree = None
        if mask is not None:
            m_cpu, m_dev = mask(cpu).numpy(), mask(dev).cpu().numpy()
            agree = f"{int((m_cpu == m_dev).sum())}/{m_cpu.size}"
            masked = int((m_cpu if name == "pulse_blanking" else ~m_cpu).sum())
        ms = "not measured"
        if device.type == "cuda":
            op(dev)
            ms = f"{_time_ms(lambda: op(dev), 50) * (0.1 * FS / n):.4f}"
        _line("conditioning", t0, op=name, max_abs_err=f"{err:.3e}",
              tol=f"{tol:.3e}", mask_agree=agree,
              **({"masked": masked} if mask is not None else {}),
              ms_per_100ms=ms)
        if err > tol or (agree is not None and not np.array_equal(m_cpu,
                                                                  m_dev)):
            raise SystemExit(f"{name} on {device} disagrees with the CPU: "
                             f"err {err:.3e} (tol {tol:.3e}), masks {agree}")


def phase_cli_notch(device, seconds: float = 4.0, check: bool = True) -> int:
    """conf/gps_l1_notch.conf (8 channels at 2 MSps) through the CLI on
    tests/test_input_filter_chain.py's scenario plus the jammer, generated
    on the card and written as ishort: once as shipped (Notch_Filter) and
    once with InputFilter.implementation=Pass_Through. Checks: >= 4 of the
    scenario's satellites tracked with the notch and more than without it;
    the host seconds of the filter. Returns the notch run's K2 launches."""
    from gnss_sdr_tpu_torch.utils import scenario

    platform = "cuda" if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    sc = scenario.build_gps_l1_scenario(duration_s=seconds, n_sats=5,
                                        cn0_dbhz=47.0, fs=FS)
    x = sc.generate(seed=3, device=device)
    x += _jammer(len(x))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        _write_ishort(tmp / "capture.ishort", x)
        del x
        _line("cli_notch", t0, step="generate", seconds_of_capture=seconds,
              prns=sorted(sc.prns))
        for impl in ("Notch_Filter", "Pass_Through"):
            conf = tmp / f"{impl}.conf"
            conf.write_text(_shipped_conf(
                "gps_l1_notch.conf",
                {"SignalSource.filename": tmp / "capture.ishort",
                 "InputFilter.implementation": impl}, {}))
            t0 = time.perf_counter()
            stdout, stderr = _run_cli(conf, platform)
            got = _summary(stdout)
            m = re.search(r"input filter: (\w+) (\d+) blocks, ([\d.]+) s",
                          stdout)
            got["filter_blocks"] = int(m.group(2)) if m else 0
            got["filter_s"] = float(m.group(3)) if m else 0.0
            got["sats"] = sorted(set(sc.prns) & set(got["tracked"]))
            runs[impl] = got
            _line("cli_notch", t0, run=impl, tracked=got["tracked"],
                  scenario_tracked=len(got["sats"]),
                  filter_blocks=got["filter_blocks"],
                  filter_host_s=f"{got['filter_s']:.3f}",
                  tracking_dispatches=got["dispatches"],
                  k2_launches=got["k2"], k1_launches=got["k1"])
            _cli_checks("cli_notch", device, got, stderr, [],
                        tracks=impl == "Notch_Filter")
    notch, plain = runs["Notch_Filter"], runs["Pass_Through"]
    if check and not (len(notch["sats"]) >= 4
                      and len(notch["sats"]) > len(plain["sats"])
                      and notch["filter_blocks"] > 0):
        raise SystemExit(f"cli_notch: {notch['sats']} tracked with the "
                         f"notch, {plain['sats']} without")
    return notch["k2"]


def phase_cli_supl(device, main_run: dict, seconds: float = SUPL_DUR,
                   check: bool = True) -> int:
    """conf/gps_l1_supl.conf (assisted PCPS acquisition) through the CLI on
    the main capture's first ``seconds`` s, its SUPL server and port
    replaced by the port's QA SuplServer on 127.0.0.1 (port 0, three
    sessions) serving the scenario's ephemerides, an almanac of every
    satellite of the constellation, the reference location and time and
    each satellite's Doppler / code phase; then the same run with SUPL off.
    Checks: the server answered three sessions (start, pos-init, the acks
    of the paged ephemerides) without error, the CLI applied every
    ephemeris and acquisition hint, every satellite tracked, and the first
    fix at an earlier stream time than without SUPL (none at all counts
    as later). Returns the SUPL run's K2 launches."""
    from gnss_sdr_tpu_torch.io.supl import SuplServer
    from gnss_sdr_tpu_torch.models.almanac import GpsAlmanac

    platform = "cuda" if device.type == "cuda" else "cpu"
    sc = main_run["sc"]
    ephs = [sc.ephemerides[p] for p in sc.prns]
    week = ephs[0].week
    srv = SuplServer(
        ephemerides=ephs, wna=week % 256,
        almanacs=[GpsAlmanac.from_ephemeris(e)
                  for _, e in sorted(sc.ephemerides.items())],
        ref_llh=(float(np.degrees(sc.rcv_llh[0])),
                 float(np.degrees(sc.rcv_llh[1])), float(sc.rcv_llh[2])),
        gps_week=week, gps_tow=sc.t0_gps, n_batches=2, n_sessions=3,
        acq_assist=[(s.prn, s.doppler_hz, (s.code_delay_s * 1.023e6) % 1023)
                    for s in sc.sats])
    srv.start()
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            t0 = time.perf_counter()
            _write_ishort(tmp / "capture.ishort",
                          main_run["x"][: int(seconds * FS)])
            for supl in (True, False):
                conf = tmp / f"supl_{supl}.conf"
                conf.write_text(_shipped_conf("gps_l1_supl.conf", {
                    "SignalSource.filename": tmp / "capture.ishort",
                    "GNSS-SDR.SUPL_gps_enabled": str(supl).lower(),
                    "GNSS-SDR.SUPL_gps_ephemeris_server": "127.0.0.1",
                    "GNSS-SDR.SUPL_gps_ephemeris_port": srv.port,
                    "GNSS-SDR.assistance_file": tmp / f"agnss_{supl}.json"},
                    {"PVT.trop_model": "OFF", "PVT.iono_model": "OFF"}))
                t1 = time.perf_counter()
                stdout, stderr = _run_cli(conf, platform)
                got = _summary(stdout)
                m = re.search(r"supl: (\d+) ephemerides, (\d+) almanacs, "
                              r"(\d+) acquisition hints", stdout)
                got["supl"] = tuple(map(int, m.groups())) if m else None
                m = re.search(r"first fix: tow=([\d.]+) s", stdout)
                got["ttff_s"] = (float(m.group(1)) - sc.t0_gps if m
                                 else float("inf"))
                if supl:
                    srv.join(timeout=30)
                runs[supl] = got
                _line("cli_supl", t1, supl=supl, assistance=got["supl"],
                      tracked=got["tracked"], first_fix_stream_s=(
                          f"{got['ttff_s']:.3f}"), tracking_dispatches=(
                          got["dispatches"]), k2_launches=got["k2"],
                      k1_launches=got["k1"])
                _cli_checks("cli_supl", device, got, stderr, [])
    finally:
        srv.join(timeout=5)
    on, off = runs[True], runs[False]
    _line("cli_supl", t0, server_sessions_error=srv.error,
          server_acks=srv.n_acks, posinit=srv.got_posinit is not None,
          first_fix_gain_s=f"{off['ttff_s'] - on['ttff_s']:.3f}")
    bad = [name for name, ok in (
        ("server", srv.error is None and not srv.is_alive()
         and srv.n_acks >= 1 and srv.got_posinit is not None),
        ("assistance applied", on["supl"] == (len(ephs), len(sc.ephemerides),
                                              len(sc.sats)))) if not ok]
    if check:
        bad += [name for name, ok in (
            ("tracked PRNs", set(sc.prns) <= set(on["tracked"])),
            ("earlier first fix", on["ttff_s"] < off["ttff_s"])) if not ok]
    if bad:
        raise SystemExit(f"the cli_supl run failed its checks: {bad}")
    return on["k2"]


def phase_cli_labsat3(device, seconds: float = LABSAT_DUR,
                      check: bool = True) -> int:
    """conf/labsat3.conf through the CLI on a LabSat 3 file of a GPS L1
    scenario (6 satellites, 47 dB-Hz, seed 17) at 16.368 MSps, generated
    on the card and written as 4-bit words by the port's encoder
    (io/sources.py encode_labsat_words) into a temporary directory that is
    deleted after the run: the CLI decodes it with the native library and
    decimates it 8:1 to 2.046 MSps on the card. Checks: every satellite
    tracked. Returns the CLI's K2 launches."""
    from gnss_sdr_tpu_torch.io import sources
    from gnss_sdr_tpu_torch.utils import scenario

    platform = "cuda" if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    sc = scenario.build_gps_l1_scenario(duration_s=seconds, n_sats=6,
                                        cn0_dbhz=47.0, fs=LABSAT_FS)
    x = sc.generate(seed=17, device=device)
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        base = pathlib.Path(tmp) / "capture"
        with open(f"{base}_0000.LS3", "wb") as f:
            f.write(sources.labsat_header(4))
            sources.encode_labsat_words(x[: len(x) // 4 * 4], 4).astype(
                "<u2").tofile(f)
        del x
        size = pathlib.Path(f"{base}_0000.LS3").stat().st_size
        conf = pathlib.Path(tmp) / "rx.conf"
        conf.write_text(_shipped_conf("labsat3.conf",
                                      {"SignalSource.filename": base},
                                      {"PVT.trop_model": "OFF",
                                       "PVT.iono_model": "OFF"}))
        _line("cli_labsat3", t0, step="write", generate_s=f"{gen_s:.3f}",
              file_mb=f"{size / 1e6:.1f}", prns=sorted(sc.prns))
        t0 = time.perf_counter()
        stdout, stderr = _run_cli(conf, platform)
    got = _summary(stdout)
    _line("cli_labsat3", t0, run="labsat3", tracked=got["tracked"],
          conditioning=f"conditioning {int(LABSAT_FS)} sps -> 2046000 sps"
          in stderr, tracking_dispatches=got["dispatches"],
          k2_launches=got["k2"], k1_launches=got["k1"])
    missed = check and not set(sc.prns) <= set(got["tracked"])
    _cli_checks("cli_labsat3", device, got, stderr,
                ["tracked PRNs"] if missed else [])
    return got["k2"]


def phase_front_end_cal(device) -> None:
    """tests/test_front_end_cal.py::test_full_cal_flow_from_capture on the
    card: 5 visible satellites at 46 dB-Hz, the front end's oscillator
    3 ppm off, 80 ms at 2 MSps; the all-PRN sweep (+-10 kHz, 250 Hz) on the
    device, then the fit. Checks: the 5 detected, <= 8 detections, the
    offset within 200 Hz and 0.15 ppm."""
    from gnss_sdr_tpu_torch import constants
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy
    from gnss_sdr_tpu_torch.utils import constellation, generator
    from gnss_sdr_tpu_torch.utils.front_end_cal import run_front_end_cal

    t0 = time.perf_counter()
    ephs = constellation.almanac_constellation()
    rcv = geodesy.geodetic_to_ecef(np.deg2rad(41.275), np.deg2rad(1.9876),
                                   80.0)
    t_gps, osc_hz = 354000.0, 3.0e-6 * 1.57542e9
    vis = constellation.visible_sats(ephs, rcv, t_gps)[:5]
    sats = [generator.SatParams(
        prn=p, cn0_dbhz=46.0, code_delay_s=1.7e-4 * k,
        doppler_hz=constellation.simulate_observation(
            ephs[p], rcv, t_gps).doppler_hz + osc_hz)
        for k, (p, _, _) in enumerate(vis)]
    x = generator.generate(constants.SIGNALS["1C"], sats, FS, 0.08, seed=3)
    t1 = time.perf_counter()
    cal, rows = run_front_end_cal(x, FS, ephs, rcv, t_gps, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    det = sorted(r.prn for r in rows if r.detected)
    _line("front_end_cal", t0, sweep_s=f"{time.perf_counter() - t1:.3f}",
          detected=det, visible=sorted(p for p, _, _ in vis),
          n_sats=cal.n_sats, offset_hz=f"{cal.clock_offset_hz:.1f}",
          truth_hz=f"{osc_hz:.1f}", ppm=f"{cal.clock_offset_ppm:.4f}")
    if not ({p for p, _, _ in vis} <= set(det) and len(det) <= 8
            and abs(cal.clock_offset_hz - osc_hz) < 200.0
            and abs(cal.clock_offset_ppm - 3.0) < 0.15):
        raise SystemExit(f"front_end_cal: {cal}, detected {det}")


def _two_bit_codes(v: np.ndarray) -> np.ndarray:
    """Real values -> the 2-bit codes of io/native.py (0: +1, 1: +3,
    2: -1, 3: -3), magnitude 3 beyond one rms."""
    big = np.abs(v) > np.sqrt(np.mean(v * v))
    return np.where(v >= 0, 0, 2).astype(np.uint8) + big.astype(np.uint8)


def _read_blocks(src, n: int, sizes=(4096, 333, 10_000, 7)) -> np.ndarray:
    out, k = [], 0
    while True:
        b = src.read(sizes[k % len(sizes)])
        k += 1
        if b.shape[-1] == 0:
            break
        out.append(b)
    return np.concatenate(out, axis=-1)[..., :n]


def phase_sources(device, rf_seconds: float = 2.8) -> int:
    """One capture (0.1 s of a 4-satellite GPS L1 scenario at 2 MSps, seed
    55) written as each capture format and read back through the port's
    sources (config.ini.source_from_ini), in word-unaligned blocks, equal
    to the numpy decoders of the raw file: SPIR int1 (channel 1), SPIR
    GSS6450 (4-bit), a 4-element raw array, 2-bit packed complex, NSR
    (2-bit real, native library); the capture as ishort datagrams through
    UdpSignalSource and as u8 IQ through RtlTcpSignalSource, both over
    127.0.0.1; then tests/test_rf_sources.py::test_uhd_conf_mock_playback_
    end_to_end: a UHD conf with the mock driver playing 3 s of the
    scenario (generated on the card) feeds the receiver (4 channels) for
    ``rf_seconds``, after which every satellite must be tracked. Returns
    that receiver's K2 launches."""
    import socket
    import threading

    from gnss_sdr_tpu_torch.config import ini
    from gnss_sdr_tpu_torch.io import native
    from gnss_sdr_tpu_torch.io import sources as srcs
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    sc = scenario.build_gps_l1_scenario(duration_s=3.0, n_sats=4,
                                        cn0_dbhz=48.0, fs=FS)
    full = sc.generate(seed=55, device=device)
    x = full[: int(0.1 * FS)]
    n = len(x)
    i_ = np.rint(x.real * 2.5).clip(-8, 7).astype(np.int64)
    q_ = np.rint(x.imag * 2.5).clip(-8, 7).astype(np.int64)
    checked = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        def source(impl, path, **keys):
            conf = ini.InMemoryConfiguration()
            for k, v in {"implementation": impl, "filename": path,
                         "sampling_frequency": int(FS), **keys}.items():
                conf.set_property(f"SignalSource.{k}", v)
            return ini.source_from_ini(conf)

        # SPIR int1: one int32 a sample, I sign in bit 0, Q sign in bit 1
        words = ((x.real > 0).astype(np.int32)
                 | ((x.imag > 0).astype(np.int32) << 1))
        words.astype("<i4").tofile(tmp / "int1.dat")
        got = _read_blocks(source("Spir_File_Signal_Source",
                                  tmp / "int1.dat"), n)
        checked["spir_int1"] = (np.array_equal(
            got, srcs.decode_spir_int1(words, 1)) and np.array_equal(
            np.sign(got.real), np.where(x.real > 0, 1, -1)))
        # SPIR GSS6450 4-bit: 4 samples a word, I then Q, reversed order
        w = np.zeros(n // 4, np.uint32)
        for k in range(4):
            j = slice(3 - k, n // 4 * 4, 4)
            w |= (i_[j] & 15).astype(np.uint32) << (8 * k)
            w |= (q_[j] & 15).astype(np.uint32) << (8 * k + 4)
        w.astype("<u4").tofile(tmp / "gss.dat")
        got = _read_blocks(source("Spir_GSS6450_File_Signal_Source",
                                  tmp / "gss.dat", adc_bits=4), n)
        checked["spir_gss6450"] = (np.array_equal(
            got, srcs.decode_spir_gss6450(w.astype(np.int32), 4))
            and np.array_equal(got, (i_ + 1j * q_).astype(np.complex64)))
        # a 4-element array, element-interleaved gr_complex
        rng = np.random.default_rng(9)
        arr = np.stack([x + (rng.standard_normal(n) + 1j
                             * rng.standard_normal(n)).astype(np.complex64)
                        for _ in range(4)])
        arr.T.reshape(-1).tofile(tmp / "array.dat")
        got = _read_blocks(source("Raw_Array_Signal_Source",
                                  tmp / "array.dat", RF_channels=4), n)
        checked["raw_array"] = np.array_equal(got, arr)
        # 2-bit packed complex (I, Q, I, Q per byte) and NSR (4 real a byte)
        c = np.stack([_two_bit_codes(x.real), _two_bit_codes(x.imag)],
                     1).reshape(-1, 4)
        cpx = (c[:, 0] | c[:, 1] << 2 | c[:, 2] << 4 | c[:, 3] << 6
               ).astype(np.uint8)
        cpx.tofile(tmp / "cpx.bin")
        got = _read_blocks(source("Two_Bit_Cpx_File_Signal_Source",
                                  tmp / "cpx.bin"), n)
        checked["two_bit_cpx"] = np.array_equal(
            got, native.decode_2bit_cpx_numpy(cpx))
        r = _two_bit_codes(x.real).reshape(-1, 4)
        nsr = (r[:, 0] | r[:, 1] << 2 | r[:, 2] << 4 | r[:, 3] << 6
               ).astype(np.uint8)
        nsr.tofile(tmp / "nsr.bin")
        got = _read_blocks(source("Nsr_File_Signal_Source",
                                  tmp / "nsr.bin"), n)
        checked["nsr"] = np.array_equal(got,
                                        native.decode_2bit_real_numpy(nsr))
        got = _read_blocks(source("Two_Bit_Packed_File_Signal_Source",
                                  tmp / "cpx.bin", sample_type="iq"), n)
        checked["two_bit_packed"] = np.array_equal(
            got, native.decode_2bit_cpx_numpy(cpx))

    # UDP: the capture as ishort datagrams
    raw = np.empty(2 * n, np.int16)
    raw[0::2] = np.rint(x.real * 300)
    raw[1::2] = np.rint(x.imag * 300)
    udp = srcs.UdpSignalSource(host="127.0.0.1", port=0, item_type="ishort",
                               sampling_frequency=FS, timeout_s=2.0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    got = []
    for part in np.array_split(raw, 100):
        tx.sendto(part.tobytes(), ("127.0.0.1", udp.port))
        got.append(udp.read(len(part) // 2))
    tx.close()
    udp.close()
    checked["udp"] = np.array_equal(np.concatenate(got),
                                    srcs.decode_samples(raw, "ishort"))
    # rtl_tcp: the capture as u8 IQ from a local server
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.rint(x.real * 30 + 127.4).clip(0, 255)
    u8[1::2] = np.rint(x.imag * 30 + 127.4).clip(0, 255)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cmds = []

    def serve():
        conn, _ = srv.accept()
        conn.sendall(b"RTL0" + bytes(8))
        buf = b""
        while len(buf) < 15:
            part = conn.recv(15 - len(buf))
            if not part:
                break
            buf += part
        cmds.extend(buf[i] for i in range(0, len(buf), 5))
        conn.sendall(u8.tobytes())
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    conf = ini.InMemoryConfiguration()
    for k, v in {"implementation": "RtlTcp_Signal_Source",
                 "address": "127.0.0.1", "port": srv.getsockname()[1],
                 "sampling_frequency": int(FS)}.items():
        conf.set_property(f"SignalSource.{k}", v)
    rtl = ini.source_from_ini(conf)
    got = np.concatenate([rtl.read(m) for m in (777, 50_000, n - 50_777)])
    th.join(timeout=10)
    rtl.close()
    srv.close()
    f = (u8.astype(np.float32) - 127.4) / 128.0
    checked["rtl_tcp"] = (sorted(cmds) == [1, 2, 8] and np.array_equal(
        got, (f[0::2] + 1j * f[1::2]).astype(np.complex64)))
    _line("sources", t0, samples=n, **checked)
    if not all(checked.values()):
        raise SystemExit(f"sources: {[k for k, v in checked.items() if not v]}"
                         f" read back wrong")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cap = pathlib.Path(tmp) / "mock_capture.cfile"
        full.astype(np.complex64).tofile(cap)
        conf = ini.InMemoryConfiguration()
        for k, v in {"implementation": "UHD_Signal_Source",
                     "sampling_frequency": int(FS), "freq": 1_575_420_000,
                     "gain": 50, "antenna": "TX/RX", "subdevice": "A:0",
                     "driver": "mock", "mock_capture": cap}.items():
            conf.set_property(f"SignalSource.{k}", v)
        src = ini.source_from_ini(conf)
    rx = Receiver(ReceiverConfig(signal="1C", fs=FS, n_channels=4,
                                 prns=tuple(sc.prns), chunk_ms=100),
                  device=device)
    tk.launches = 0
    rx.run_source(src, max_chunks=int(round(rf_seconds * 10)))
    src.close()
    k2 = tk.launches
    tracked = sorted(rx.tracked_prns())
    _line("sources", t0, run="uhd_mock_playback", seconds_of_capture=(
        rf_seconds), delivered=src.driver.samples_delivered, tracked=tracked,
        tracking_dispatches=rx.tracking_dispatches, k2_launches=k2)
    if tracked != sorted(sc.prns) or (device.type == "cuda" and not
                                      k2 == rx.tracking_dispatches > 0):
        raise SystemExit(f"the mock UHD receiver tracked {tracked}, expected "
                         f"{sorted(sc.prns)}, K2 launches {k2}")
    return k2


# ------------------------------------------------------- multi-source ---
MS_T0, MS_DUR = 352800.08, 42.0       # tests/test_e2e_multisource.py
MS_FS_L1, MS_FS_L5, MS_FS_GLO = 2.0e6, 12.0e6, 8.0e6
MS_CLI_S = 4.0


def dual_band_capture(device, duration_s: float) -> dict:
    """tests/test_e2e_multisource.py's dual-band captures, generated on
    ``device``: GPS L1 C/A at 2 MSps and GPS L5 at 12 MSps, 7 satellites
    each at 50 dB-Hz (10 degree mask), ``duration_s`` from T0 352800.08,
    seeds 101 / 102; with the seconds each took."""
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    sc1 = scenario.build_gps_l1_scenario(
        t0_gps=MS_T0, duration_s=duration_s, n_sats=7, cn0_dbhz=50.0,
        fs=MS_FS_L1, el_mask_deg=10.0)
    sc5 = scenario.build_gps_l5_scenario(
        t0_gps=MS_T0, duration_s=duration_s, n_sats=7, cn0_dbhz=50.0,
        fs=MS_FS_L5, el_mask_deg=10.0)
    x1 = sc1.generate(seed=101, device=device)
    t1 = time.perf_counter()
    x5 = sc5.generate(seed=102, device=device)
    return dict(sc1=sc1, sc5=sc5, x1=x1, x5=x5, l1_s=t1 - t0,
                l5_s=time.perf_counter() - t1)


def gps_glonass_capture(device, duration_s: float | None) -> dict:
    """tests/test_e2e_multisource.py's GPS + GLONASS captures, generated on
    ``device``: GLONASS L1, 4 satellites at 48 dB-Hz, 8 MSps, t0_day
    7200.08, seed 104, the scenario's own duration (``duration_s`` cuts
    it), and GPS L1 C/A, 6 satellites at 47 dB-Hz, 2 MSps, seed 103, as
    long, rounded up; with the seconds they took."""
    from gnss_sdr_tpu_torch.utils import scenario

    t0 = time.perf_counter()
    sc_r = scenario.build_glonass_l1_scenario(t0_day=7200.08, fs=MS_FS_GLO,
                                              n_sats=4, cn0_dbhz=48.0)
    if duration_s is not None:
        sc_r.duration_s = duration_s
    dur = float(np.ceil(sc_r.duration_s))
    sc_g = scenario.build_gps_l1_scenario(t0_gps=MS_T0, duration_s=dur,
                                          n_sats=6, cn0_dbhz=47.0,
                                          fs=MS_FS_L1)
    x_g = sc_g.generate(seed=103, device=device)
    x_r = sc_r.generate(seed=104, device=device)
    return dict(sc_g=sc_g, sc_r=sc_r, x_g=x_g, x_r=x_r, dur=dur,
                seconds=time.perf_counter() - t0)


def _branch_launches(ms) -> list:
    """Count each branch's K2 launches: the launch counter's growth across
    each of the branch's tracking dispatches (an instance attribute
    shadowing the method; the receiver is not changed)."""
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk

    counts = [0] * len(ms.receivers)
    for bi, r in enumerate(ms.receivers):
        def wrapper(*a, _fn=r._dispatch_tracking, _bi=bi, **kw):
            n0 = tk.launches
            try:
                return _fn(*a, **kw)
            finally:
                counts[_bi] += tk.launches - n0
        r._dispatch_tracking = wrapper
    return counts


def _ms_run(device, phase: str, branches: list, extra_sinks=()) -> dict:
    """One MultiSourceReceiver over ``branches`` [(signal, fs, n_ch, prns,
    x)] with the solver without an atmosphere: the receiver line (wall,
    each branch's tracked PRNs, dispatches and K2 launches) and the checks
    every multi-source run shares: each branch launched K2 once per
    tracking dispatch and K1 never (on the card)."""
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.multisource import (MultiSourceReceiver,
                                                         SourceBranchConfig)
    from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig

    t0 = time.perf_counter()
    ms = MultiSourceReceiver([SourceBranchConfig(
        receiver=ReceiverConfig(signal=sig, fs=fs, n_channels=n,
                                prns=tuple(prns), chunk_ms=100,
                                pvt_apply_tropo=False, pvt_apply_iono=False),
        source=ArraySignalSource(x, fs)) for sig, fs, n, prns, x in branches],
        device=device)
    for sink in extra_sinks:
        ms.obs_sinks.append(sink)
    launches = _branch_launches(ms)
    correlator.launches = 0
    tk.launches = 0
    ms.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracked = ms.tracked_prns()
    disp = [r.tracking_dispatches for r in ms.receivers]
    _line(phase, t0, step="receiver", wall_s=f"{wall:.3f}",
          stream_s=[f"{len(b[4]) / b[1]:.3f}" for b in branches],
          tracked=[sorted(tracked[i]) for i in range(len(branches))],
          scenario=[sorted(b[3]) for b in branches], dispatches=disp,
          k2_launches=launches, k1_launches=correlator.launches,
          fixes=len(ms.fixes))
    if device.type == "cuda" and not (
            launches == disp and all(d > 0 for d in disp)
            and correlator.launches == 0 and tk.launches == sum(disp)):
        raise SystemExit(f"{phase}: K2 launches {launches} != dispatches "
                         f"{disp}, or K1 launched {correlator.launches} "
                         f"times")
    return dict(ms=ms, k2_launches=launches, wall_s=wall, t0=t0)


def _ms_fix_checks(fixes, sc, min_sats: int) -> tuple:
    """tests/test_e2e_multisource.py's fix budget: the mean ENU offset of
    the last 5 fixes within 2D < 2 m and 3D < 5 m, the last fix with at
    least ``min_sats`` satellites."""
    err = _fix_error(fixes[-5:], sc) if fixes else (np.inf, np.inf)
    n_sats = fixes[-1].n_sats if fixes else 0
    return err, n_sats, err[0] < 2.0 and err[1] < 5.0 and n_sats >= min_sats


def _wide_lane_truth(sc1, ppp, raw_epochs) -> tuple:
    """tests/test_e2e_multisource.py:204-247: each held wide-lane integer
    against the truth-geometry integer (between-satellite single
    differences of the phase minus the true range, per signal). Returns
    (held, checked, wrong)."""
    from gnss_sdr_tpu_torch import constants as C

    om, c = 7.2921151467e-5, C.SPEED_OF_LIGHT_M_S
    consts: dict = {}
    for epoch in raw_epochs[::25]:
        for o in epoch:
            if o.signal not in ("1C", "L5"):
                continue
            eph = sc1.ephemerides[o.prn]
            dts = eph.clock_offset(o.t_tx_sv)
            p, _v = eph.position_velocity(o.t_tx_sv - dts)
            tau = np.linalg.norm(p - sc1.rcv_ecef) / c
            th = om * tau
            rot = np.array([[np.cos(th), np.sin(th), 0.0],
                            [-np.sin(th), np.cos(th), 0.0], [0, 0, 1.0]])
            rho = np.linalg.norm(rot @ p - sc1.rcv_ecef)
            lam = c / (o.carrier_freq_hz
                       or C.SIGNALS[o.signal].carrier_freq_hz)
            consts.setdefault((o.signal, o.prn), []).append(
                o.carrier_phase_cycles * lam - (rho - c * dts))
    lam1, lam5 = c / 1_575_420_000.0, c / 1_176_450_000.0
    held = ppp.filter.fixed_wl
    ref = ppp.filter._last_fix[0][1] if ppp.filter._last_fix else None
    if ref is None and ppp.filter._mw:
        ref = max((k for k in ppp.filter._mw),
                  key=lambda k: ppp.filter._mw[k][0])[1]
    checked, wrong = 0, []
    for (_, prn), wl_held in held.items():
        try:
            a1 = np.mean(consts[("1C", prn)]) - np.mean(consts[("1C", ref)])
            a5 = np.mean(consts[("L5", prn)]) - np.mean(consts[("L5", ref)])
        except KeyError:
            wrong.append((prn, wl_held, None))
            continue
        wl_true = a1 / lam1 - a5 / lam5
        if abs(wl_true - round(wl_true)) >= 0.35 or wl_held != round(wl_true):
            wrong.append((prn, wl_held, float(wl_true)))
        checked += 1
    return dict(held), checked, wrong


def phase_ms_dual_band(device, cap: dict, check: bool,
                       cli_s: float = MS_CLI_S) -> dict:
    """tests/test_e2e_multisource.py's dual-band run on the card: its
    captures (``dual_band_capture``, consumed: the phase frees them), one
    branch each of a MultiSourceReceiver with
    the solver without an atmosphere, and tests/test_e2e_multisource.py's
    PppEngine fed from its merged observables (obs_sinks): both branches
    track their PRN sets; every L5 PRN's ephemeris in the shared store
    (sqrt_a within 1e-3 of the truth); the last 5 merged fixes within
    2D < 2 m / 3D < 5 m with >= 6 satellites; PPP: solutions, no
    narrow-lane fix, the last success rate < 0.9, the final float within
    0.6 m horizontally and 1.0 m vertically; >= 4 held wide-lane integers,
    each the truth-geometry integer. Then K2 on each branch's final carry,
    and ``cli_multisource`` on the captures' first ``cli_s`` seconds.
    Returns each branch's K2 launches."""
    from gnss_sdr_tpu_torch.receiver.pvt import geodesy
    from gnss_sdr_tpu_torch.receiver.pvt.ppp_engine import PppEngine

    sc1, sc5 = cap["sc1"], cap["sc5"]
    x1, x5 = cap.pop("x1"), cap.pop("x5")
    print(f"[ms_dual_band] step=generate samples={[len(x1), len(x5)]} "
          f"prns={[sorted(sc1.prns), sorted(sc5.prns)]} "
          f"l1_seconds={cap['l1_s']:.3f} l5_seconds={cap['l5_s']:.3f}",
          flush=True)
    if not set(sc5.prns) <= set(sc1.prns):
        raise SystemExit(f"L5 PRNs {sc5.prns} not among L1's {sc1.prns}")

    keyed = {("G", p): sc1.ephemerides[p] for p in sc1.prns}
    ppp = PppEngine(keyed, x0_ecef=(0.0, 0.0, 0.0), mode="static",
                    estimate_tropo=False, sigma_pr_m=0.7,
                    sigma_phase_m=0.004, obs_spacing_s=0.5,
                    ratio_threshold=2.5, code_bias_m=0.15)
    ppp.seed_position(sc1.rcv_ecef + np.array([11.0, -7.0, 16.0]))
    raw_epochs: list = []
    run = _ms_run(device, "ms_dual_band", [
        ("1C", MS_FS_L1, 7, sc1.prns, x1), ("L5", MS_FS_L5, 7, sc5.prns, x5)],
        extra_sinks=(ppp.push_epoch,
                     lambda t, obs: raw_epochs.append(list(obs))))
    ms = run["ms"]
    tracked = ms.tracked_prns()
    k2_err = None
    for bi, (x, name) in enumerate(((x1, "ms_l1_final_carry"),
                                    (x5, "ms_l5_final_carry"))):
        k2_err = _worst(k2_err, phase_k2_case(
            name, device, *_final_carry_case(ms.receivers[bi], x)))
    cli_k2 = phase_cli_multisource(device, x1, x5, sc1, sc5, cli_s)
    del x1, x5
    if check:
        t2 = time.perf_counter()
        bad_eph = [p for p in sc5.prns if ("G", p) not in ms.ephemerides
                   or abs(ms.ephemerides[("G", p)].sqrt_a
                          - sc1.ephemerides[p].sqrt_a) >= 1e-3]
        err, n_sats, fix_ok = _ms_fix_checks(ms.fixes, sc1,
                                             len(sc1.prns) - 1)
        lat, lon, _ = sc1.rcv_llh
        final = ppp.solutions[-1] if ppp.solutions else None
        enu = (geodesy.ecef_to_enu(final.pos_ecef - sc1.rcv_ecef, lat, lon)
               if final is not None else np.full(3, np.inf))
        held, checked, wrong = _wide_lane_truth(sc1, ppp, raw_epochs)
        _line("ms_dual_band", t2, step="checks",
              ephemerides=len(ms.ephemerides), eph_bad=bad_eph,
              fixes=len(ms.fixes), err_2d_m=f"{err[0]:.3f}",
              err_3d_m=f"{err[1]:.3f}", n_sats=n_sats,
              ppp_solutions=len(ppp.solutions),
              nl_fixed_epochs=ppp.filter.n_fixed_epochs,
              last_success_rate=f"{ppp.filter.last_success_rate:.4f}",
              ppp_h_m=f"{np.hypot(enu[0], enu[1]):.3f}",
              ppp_v_m=f"{enu[2]:.3f}", wide_lanes_held=len(held),
              wide_lanes_checked=checked, wide_lanes_wrong=wrong,
              merged_epochs=len(raw_epochs))
        bad = [what for what, ok in (
            ("L1 tracked", sorted(tracked[0]) == sorted(sc1.prns)),
            ("L5 tracked", sorted(tracked[1]) == sorted(sc5.prns)),
            ("ephemerides", len(ms.ephemerides) >= len(sc5.prns)
             and not bad_eph),
            ("merged fix", len(ms.fixes) >= 3 and fix_ok),
            ("PPP solutions", bool(ppp.solutions)),
            ("no narrow-lane fix", ppp.filter.n_fixed_epochs == 0),
            ("success rate", ppp.filter.last_success_rate < 0.9),
            ("PPP float", np.hypot(enu[0], enu[1]) < 0.6
             and abs(enu[2]) < 1.0),
            ("wide lanes", len(held) >= 4 and checked >= 4 and not wrong))
            if not ok]
        if bad:
            raise SystemExit(f"ms_dual_band phase failed its checks: {bad}")
    return dict(l1_launches=run["k2_launches"][0],
                l5_launches=run["k2_launches"][1], cli_launches=cli_k2,
                k2_err=k2_err)


def _ms_summary(stdout: str) -> dict:
    """The multi-source CLI's summary: per branch (signals, tracked PRNs,
    dispatches) and the launch counts."""
    branches = [dict(signals=re.findall(r"'(\w+)'", m.group(2)),
                     tracked=[int(v) for v in m.group(3).split(",")
                              if v.strip()], dispatches=int(m.group(4)))
                for m in re.finditer(
                    r"branch (\d+): signals=(\[[^\]]*\]) fs=\d+ samples=\d+ "
                    r"tracked PRNs: \[([\d, ]*)\]; tracking_dispatches=(\d+)",
                    stdout)]
    m = re.search(r"tracking_dispatches=(\d+) tracking_kernel_launches=(\d+) "
                  r"multicorrelator_launches=(\d+)", stdout)
    if m is None or not branches:
        raise SystemExit(f"no multi-source summary in the CLI's output: "
                         f"{stdout!r}")
    return dict(branches=branches, dispatches=int(m.group(1)),
                k2=int(m.group(2)), k1=int(m.group(3)))


def phase_cli_multisource(device, x1, x5, sc1, sc5, seconds: float) -> int:
    """The dual-band captures' first ``seconds`` as two ishort files through
    a two-source conf of tests/test_multisource.py's MULTISOURCE_CONF form
    (SignalSource0 at 2 MSps for Channels_1C, SignalSource1 at 12 MSps for
    Channels_L5, Resampler1.sample_freq_out=12000000,
    Channel7.RF_channel_ID=1) by ``python -m gnss_sdr_tpu_torch -c``: both
    branches dispatch and track satellites of their captures only, K2
    launched once per dispatch and K1 never. Returns the K2 launches."""
    platform = "cuda" if device.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        f0, f1 = tmp / "l1.ishort", tmp / "l5.ishort"
        _write_ishort(f0, x1[: int(seconds * MS_FS_L1)])
        _write_ishort(f1, x5[: int(seconds * MS_FS_L5)])
        conf = tmp / "ms.conf"
        keys = {"GNSS-SDR.internal_fs_sps": 2000000,
                "Receiver.sources_count": 2,
                "Channels_1C.count": 7, "Channels_L5.count": 7,
                "Channel0.RF_channel_ID": 0, "Channel7.RF_channel_ID": 1,
                "Resampler1.sample_freq_out": 12000000,
                "PVT.trop_model": "OFF", "PVT.iono_model": "OFF"}
        for k, (f, fs) in enumerate(((f0, MS_FS_L1), (f1, MS_FS_L5))):
            keys.update({f"SignalSource{k}.implementation":
                         "File_Signal_Source",
                         f"SignalSource{k}.filename": f,
                         f"SignalSource{k}.item_type": "ishort",
                         f"SignalSource{k}.sampling_frequency": int(fs)})
        conf.write_text("".join(f"{k}={v}\n" for k, v in keys.items()))
        t1 = time.perf_counter()
        stdout, stderr = _run_cli(conf, platform)
        cli_s = time.perf_counter() - t1
    got = _ms_summary(stdout)
    br = got["branches"]
    _line("cli_multisource", t0, seconds_of_capture=seconds,
          cli_seconds=f"{cli_s:.3f}",
          branches=[b["signals"] for b in br],
          tracked=[b["tracked"] for b in br],
          branch_dispatches=[b["dispatches"] for b in br],
          tracking_dispatches=got["dispatches"], k2_launches=got["k2"],
          k1_launches=got["k1"])
    scen = (sorted(sc1.prns), sorted(sc5.prns))
    bad = [label for label, ok in (
        ("branches", [b["signals"] for b in br] == [["1C"], ["L5"]]),
        ("tracking", all(b["dispatches"] > 0 and b["tracked"]
                         and set(b["tracked"]) <= set(s)
                         for b, s in zip(br, scen))))
        if not ok]
    _cli_checks("cli_multisource", device, got, stderr, bad)
    return got["k2"]


def phase_ms_gps_glonass(device, cap: dict, check: bool) -> dict:
    """tests/test_e2e_multisource.py's GPS + GLONASS run on the card: its
    captures (``gps_glonass_capture``, consumed), one branch each, on
    their own time scales: both branches track their PRN sets, >= 3
    fixes, a merged fix with both a G and an R clock, the last 5 such
    fixes within 2D < 2 m / 3D < 5 m with >= 8 satellites. Then K2 on each
    branch's final carry."""
    sc_g, sc_r = cap["sc_g"], cap["sc_r"]
    x_g, x_r = cap.pop("x_g"), cap.pop("x_r")
    print(f"[ms_gps_glonass] step=generate samples={[len(x_g), len(x_r)]} "
          f"prns={[sorted(sc_g.prns), sorted(sc_r.prns)]} "
          f"stream_s={[cap['dur'], round(sc_r.duration_s, 3)]} "
          f"seconds={cap['seconds']:.3f}", flush=True)
    run = _ms_run(device, "ms_gps_glonass", [
        ("1C", MS_FS_L1, 6, sc_g.prns, x_g),
        ("1G", MS_FS_GLO, 4, sc_r.prns, x_r)])
    ms = run["ms"]
    k2_err = None
    for bi, (x, name) in enumerate(((x_g, "ms_gps_final_carry"),
                                    (x_r, "ms_glo_final_carry"))):
        k2_err = _worst(k2_err, phase_k2_case(
            name, device, *_final_carry_case(ms.receivers[bi], x)))
    del x_g, x_r
    if check:
        t1 = time.perf_counter()
        tracked = ms.tracked_prns()
        merged = [f for f in ms.fixes if "R" in f.system_clock_s
                  and "G" in f.system_clock_s]
        err, n_sats, fix_ok = _ms_fix_checks(merged, sc_g, 8)
        _line("ms_gps_glonass", t1, step="checks", fixes=len(ms.fixes),
              merged_fixes=len(merged), err_2d_m=f"{err[0]:.3f}",
              err_3d_m=f"{err[1]:.3f}", n_sats=n_sats,
              ephemerides=sorted(ms.ephemerides))
        bad = [what for what, ok in (
            ("GPS tracked", sorted(tracked[0]) == sorted(sc_g.prns)),
            ("GLONASS tracked", sorted(tracked[1]) == sorted(sc_r.prns)),
            ("fixes", len(ms.fixes) >= 3),
            ("merged G + R fix", bool(merged) and fix_ok)) if not ok]
        if bad:
            raise SystemExit(f"ms_gps_glonass phase failed its checks: {bad}")
    return dict(gps_launches=run["k2_launches"][0],
                glo_launches=run["k2_launches"][1], k2_err=k2_err)


def phase_e1_8ms(device, cap: dict, hyb: dict) -> int:
    """The hybrid capture again through a receiver of the hybrid phase's E1
    group alone (6 channels, its loop settings) with
    ``acq_variant="e1_8ms"`` (Galileo_E1_PCPS_8ms_Ambiguous_Acquisition):
    the same E1 PRNs acquired and tracked as the hybrid phase's PCPS, K2
    once per dispatch. Then pcps_8ms_search (on an E1 satellite), cccwsr_search (E1
    data + pilot) and quicksync_search (a GPS satellite, folded by 2) on
    card tensors against the same functions on the CPU: peak cell (code
    phase, Doppler) equal and the CFAR statistic within rtol 1e-3
    (tests/test_torch_acquisition.py's tolerance). Returns the K2
    launches."""
    from gnss_sdr_tpu_torch import constants
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.models import codes
    from gnss_sdr_tpu_torch.ops import acquisition as acq
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    sc_g, sc_e, x = cap["sc_g"], cap["sc_e"], cap["x"]
    t0 = time.perf_counter()
    cfg = ReceiverConfig(
        fs=HYB_FS, chunk_ms=100, signal="1B", n_channels=6,
        prns=tuple(sc_e.prns), acq_variant="e1_8ms",
        acq_doppler_max_hz=5000.0, acq_doppler_step_hz=125.0,
        pll_bw_hz=20.0, dll_bw_hz=2.0, pll_bw_narrow_hz=8.0,
        dll_bw_narrow_hz=0.75, pvt_apply_tropo=False, pvt_apply_iono=False)
    rx = Receiver(cfg, device=device)
    correlator.launches = 0
    tk.launches = 0
    rx.run_source(ArraySignalSource(x, HYB_FS))
    if device.type == "cuda":
        torch.cuda.synchronize()
    k1, k2 = correlator.launches, tk.launches
    g8 = rx.groups[0]
    tracked = sorted(ch.prn for ch in g8.channels if ch.state == "tracking")
    pcps = sorted(ch.prn for ch in hyb["rx"].groups[1].channels
                  if ch.state == "tracking")
    _line("e1_8ms", t0, step="receiver", variant=g8.rx_cfg.acq_variant,
          window=list(rx._acq_window(g8)), tracked_e1=tracked,
          pcps_tracked_e1=pcps, dispatches=rx.tracking_dispatches,
          k2_launches=k2, k1_launches=k1)
    bad = []
    if tracked != pcps:
        bad.append(f"E1 tracked {tracked} with e1_8ms, {pcps} with PCPS")
    if device.type == "cuda" and not (k2 == rx.tracking_dispatches > 0
                                      and k1 == 0):
        bad.append(f"K2 launches {k2} != dispatches {rx.tracking_dispatches}"
                   f", or K1 launched {k1} times")

    # the variant searches on card tensors against the CPU
    spec = constants.SIGNALS["1B"]
    spc = int(round(HYB_FS * spec.code_period_s))
    spchip = max(1, int(np.ceil(HYB_FS / spec.code_rate_cps)))
    boc = spec.subcarrier_rate_hz
    prn_e = sorted(sc_e.prns)[0]
    rep = codes.sample_code(codes.code_chips("1B", prn_e), HYB_FS,
                            spec.code_rate_cps, spc, boc_rate=boc)
    rep_p = codes.sample_code(codes.pilot_code_chips("1B", prn_e), HYB_FS,
                              spec.code_rate_cps, spc, boc_rate=boc)

    def cf(r):
        return np.conj(np.fft.fft(r))[None].astype(np.complex64)
    dop = acq.make_doppler_grid(5000, 125)
    seg = x[spc: 3 * spc]
    prn_g = sorted(sc_g.prns)[0]
    spc_g = int(HYB_FS * 1e-3)
    rep_g = codes.sample_code(codes.code_chips("1C", prn_g), HYB_FS,
                              1.023e6, spc_g)
    folded = rep_g.reshape(2, spc_g // 2).sum(axis=0)
    cases = {
        "pcps_8ms": (acq.pcps_8ms_search,
                     (seg, cf(np.concatenate([rep, rep])),
                      cf(np.concatenate([rep, -rep])), dop),
                     dict(fs=HYB_FS, samples_per_code=spc,
                          samples_per_chip=spchip)),
        "cccwsr": (acq.cccwsr_search, (seg, cf(rep), cf(rep_p), dop),
                   dict(fs=HYB_FS, samples_per_code=spc,
                        samples_per_chip=spchip, noncoherent=2)),
        "quicksync": (acq.quicksync_search, (x[:spc_g], cf(folded), dop),
                      dict(fs=HYB_FS, samples_per_code=spc_g,
                           folding_factor=2, samples_per_chip=4)),
    }
    for name, (fn, args, kw) in cases.items():
        t1 = time.perf_counter()
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        want = fn(*host, **kw)
        got = fn(*[a.to(device) for a in host], **kw)
        same_cell = (int(got.code_phase[0]) == int(want.code_phase[0])
                     and float(got.doppler_hz[0]) == float(want.doppler_hz[0]))
        rel = abs(float(got.test_cfar[0]) - float(want.test_cfar[0])) / \
            float(want.test_cfar[0])
        _line("e1_8ms", t1, search=name, device_cell=[
            int(got.code_phase[0]), float(got.doppler_hz[0])],
            cpu_cell=[int(want.code_phase[0]), float(want.doppler_hz[0])],
            cfar=f"{float(got.test_cfar[0]):.4f}", cfar_rel_err=f"{rel:.3e}")
        if not (same_cell and rel <= 1e-3):
            bad.append(f"{name}: cell {same_cell}, CFAR rel err {rel:.3e}")
    if bad:
        raise SystemExit(f"e1_8ms phase failed its checks: {bad}")
    return k2


def phase_tcp(device, main_run: dict, seconds: float) -> dict:
    """The main capture's first ``seconds`` on a GPS L1 C/A group with
    ``tcp_connector=True`` (GPS_L1_CA_TCP_CONNECTOR_Tracking): one
    LoopFilterPeer thread per channel on 127.0.0.1 (ephemeral ports, every
    socket with a timeout), the loops stepped on the host through the
    peers, each round's epochs correlated by K1 on the chunk the receiver
    uploaded (acquisition on the card too), no K2 launch.
    tests/test_tcp_tracking.py:148-170's checks for every satellite: its
    channel tracking, the last record's carrier within 5 Hz of the truth
    Doppler, C/N0 > 40 dB-Hz, no peer error. K1 launches once per round of
    the engine; its first round's inputs go through K1's plain version too
    (max_abs_err against K1's RTOL / ATOL). The engine's seconds in the
    correlations (upload of the round's parameters, the launch, the taps'
    download) and in the exchanges with the peers, per round. Returns the
    K2 and K1 launches and K1's error on the path."""
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver import tcp_tracking
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

    sc, x = main_run["sc"], main_run["x"][: int(seconds * FS)]
    t0 = time.perf_counter()
    rx = Receiver(ReceiverConfig(
        signal="1C", fs=FS, n_channels=len(sc.prns), prns=tuple(sc.prns),
        chunk_ms=100, tcp_connector=True, tcp_port_ch0=0), device=device)
    g = rx.groups[0]
    eng = g.tcp_engine
    peers = [tcp_tracking.LoopFilterPeer(p, code_period_s=1e-3)
             for p in eng.ports]
    for p in peers:
        p.start()
    # the first round's inputs, kept to hold K1 against its plain version
    # (the wrapper is called through unchanged and counts its launch)
    first: list = []
    launch = correlator.batch_epoch_correlate

    def spy(*a, **kw):
        if not first:
            first.append(([t.clone() if isinstance(t, torch.Tensor) else t
                           for t in a], dict(kw)))
        return launch(*a, **kw)
    correlator.batch_epoch_correlate = spy
    correlator.launches = 0
    tk.launches = 0
    try:
        rx.run_source(ArraySignalSource(x, FS))
    finally:
        correlator.batch_epoch_correlate = launch
        rx.close()
        for p in peers:
            p.join(timeout=30)
    k1, k2 = correlator.launches, tk.launches
    wall = time.perf_counter() - t0
    k1_err = float("nan")
    if first:
        a, kw = first[0]
        got = launch(*a, **kw)
        want = correlator.epoch_correlate_plain(*a, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        gk, wk = got.double().cpu().numpy(), want.double().cpu().numpy()
        k1_err = float(np.abs(gk - wk).max())
        k1_ok = bool(np.allclose(gk, wk, rtol=RTOL, atol=ATOL)
                     and np.isfinite(gk).all())
    truth = {s.prn: s for s in sc.sats}
    rows, bad = [], []
    for ch in g.channels:
        last = ch.last_record()
        if ch.state != "tracking" or last is None:
            bad.append(f"channel {ch.ch_id} {ch.state}")
            continue
        t = last.abs_start_sample / FS
        s = truth[ch.prn]
        fd = (s.doppler_hz + s.doppler_rate_hz_s * t
              + 0.5 * s.doppler_jerk_hz_s2 * t * t)
        rows.append((ch.prn, round(float(last.carrier_freq - fd), 3),
                     round(float(last.cn0_dbhz), 2)))
        if not (abs(last.carrier_freq - fd) < 5.0 and last.cn0_dbhz > 40.0):
            bad.append(f"PRN {ch.prn}: carrier {last.carrier_freq - fd:+.2f}"
                       f" Hz from the truth, C/N0 {last.cn0_dbhz:.1f}")
    errors = [repr(p.error) for p in peers if p.error is not None]
    alive = sum(p.is_alive() for p in peers)
    rounds = max(eng.rounds, 1)
    _line("tcp", t0, wall_s=f"{wall:.3f}", stream_s=f"{seconds:.3f}",
          tracked=sorted(rx.tracked_prns()), scenario=sorted(sc.prns),
          prn_carrier_err_hz_cn0=rows, peer_errors=errors, peers_alive=alive,
          dispatches=rx.tracking_dispatches, k2_launches=k2,
          k1_launches=k1, rounds=eng.rounds, epochs=eng.epochs,
          k1_max_abs_err=f"{k1_err:.3e}",
          correlate_s=f"{eng.seconds['correlate']:.4f}",
          exchange_s=f"{eng.seconds['exchange']:.4f}",
          correlate_us_per_round=f"{eng.seconds['correlate'] / rounds * 1e6:.1f}",
          exchange_us_per_round=f"{eng.seconds['exchange'] / rounds * 1e6:.1f}",
          exchange_us_per_epoch=f"{eng.seconds['exchange'] / max(eng.epochs, 1) * 1e6:.1f}")
    if sorted(rx.tracked_prns()) != sorted(sc.prns):
        bad.append(f"tracked {sorted(rx.tracked_prns())}")
    if errors or alive or k2:
        bad.append(f"peer errors {errors}, {alive} peers alive, K2 {k2}")
    if device.type == "cuda" and not (k1 == eng.rounds > 0 and first
                                      and k1_ok):
        bad.append(f"K1 launches {k1} for {eng.rounds} rounds, K1 against "
                   f"its plain version {k1_err:.3e}")
    if bad:
        raise SystemExit(f"tcp phase failed its checks: {bad}")
    return dict(k2_launches=k2, k1_launches=k1, k1_err=k1_err)


def phase_dumps(device, main_run: dict, seconds: float) -> int:
    """The main capture's first ``seconds`` with ``dump_dir`` a temporary
    directory, warm-started with the main run's ephemerides (an assistance
    record): the four npz dumps read back with ``utils/dump_tools`` (no
    plots), each PRN's last tracking rows equal to the receiver's own
    channel records, one PVT row per fix, one observables row per satellite
    of every epoch, the acquisition rows naming the tracked PRNs as
    positive. Returns the K2 launches."""
    from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
    from gnss_sdr_tpu_torch.ops import correlator
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.utils import dump_tools

    sc, x = main_run["sc"], main_run["x"][: int(seconds * FS)]
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        rx = Receiver(ReceiverConfig(
            signal="1C", fs=FS, n_channels=8, prns=tuple(sc.prns),
            chunk_ms=100, pvt_apply_tropo=False, pvt_apply_iono=False,
            dump_dir=str(tmp)), device=device)
        rx.ephemerides.update(main_run["rx"].ephemerides)
        n_obs = []
        rx.obs_sinks.append(lambda t, obs: n_obs.append(len(obs)))
        correlator.launches = 0
        tk.launches = 0
        rx.run_source(ArraySignalSource(x, FS))
        if device.type == "cuda":
            torch.cuda.synchronize()
        k1, k2 = correlator.launches, tk.launches
        rx.close()
        files = sorted(p.name for p in tmp.glob("*.npz"))
        trk = dump_tools.read_tracking(tmp / "tracking.npz")
        acq = dump_tools.read_acquisition(tmp / "acquisition.npz")
        obs = (dump_tools.read_observables(tmp / "observables.npz")
               if n_obs else {"prn": []})
        pvt = (dump_tools.read_pvt(tmp / "pvt.npz") if rx.fixes
               else {"x": []})
        mismatch = []
        for ch in rx.channels:
            if ch.state != "tracking":
                continue
            recs = ch.records
            t = {k: v[-len(recs):] for k, v in trk.get(ch.prn, {}).items()}
            if not t or not (
                    np.array_equal(t["abs_sample"],
                                   [r.abs_start_sample for r in recs])
                    and np.array_equal(t["epoch"],
                                       [r.epoch_index for r in recs])
                    and np.array_equal(
                        t["carrier_doppler_hz"],
                        np.float32([r.carrier_freq for r in recs]))
                    and np.array_equal(
                        t["rem_code_phase_chips"],
                        np.float32([r.rem_code_phase for r in recs]))
                    and np.array_equal(t["cn0_dbhz"],
                                       np.float32([r.cn0_dbhz
                                                   for r in recs]))):
                mismatch.append(ch.prn)
        positive = sorted({int(p) for p, ok in zip(acq["prn"],
                                                   acq["positive"]) if ok})
        enu = (dump_tools.pvt_enu(pvt, sc.rcv_ecef) if len(pvt["x"])
               else np.zeros((0, 3)))
        _line("dumps", t0, stream_s=f"{seconds:.3f}", files=files,
              tracking_prns=sorted(trk), tracking_rows=sum(
                  len(v["epoch"]) for v in trk.values()),
              records_mismatch=mismatch, acquisition_rows=len(acq["prn"]),
              acquisition_positive=positive,
              observables_rows=len(obs["prn"]), observables_epochs=len(n_obs),
              pvt_rows=len(pvt["x"]), fixes=len(rx.fixes),
              last_fix_err_3d_m=(f"{np.linalg.norm(enu[-1]):.3f}"
                                 if len(enu) else None),
              dispatches=rx.tracking_dispatches, k2_launches=k2,
              k1_launches=k1)
    tracked = sorted(rx.tracked_prns())
    full = device.type == "cuda"
    for label, ok in (
            ("files", not full or files == ["acquisition.npz",
                                            "observables.npz", "pvt.npz",
                                            "tracking.npz"]),
            ("tracking PRNs", sorted(trk) == tracked == sorted(sc.prns)),
            ("records", not mismatch),
            ("acquisition", positive == tracked),
            ("observables", len(obs["prn"]) == sum(n_obs)),
            ("PVT rows", len(pvt["x"]) == len(rx.fixes)
             and (not full or len(rx.fixes) > 0)),
            ("K2 launches", not full or (k2 == rx.tracking_dispatches > 0
                                         and k1 == 0))):
        if not ok:
            bad.append(label)
    if bad:
        raise SystemExit(f"dumps phase failed its checks: {bad}")
    return k2


def phase_nonlinear_kf(device) -> None:
    """The cubature and unscented filter banks (ops/nonlinear_kf.py,
    ``batched_predict`` / ``batched_update`` over 128 channels, a linear
    transition and a sine measurement model, float64) on ``device`` against
    the same functions on the CPU, within rtol 1e-5 (the tolerance the CPU
    tests hold the port to JAX with)."""
    from gnss_sdr_tpu_torch.ops import nonlinear_kf as nkf

    rng = np.random.default_rng(11)
    c, nx, ny = 128, 3, 2
    host = dict(
        f=rng.uniform(0.1, 1.0, (nx, nx)), h=rng.uniform(0.1, 1.0, (ny, nx)),
        x=rng.standard_normal((c, nx)),
        p=np.stack([np.diag(rng.uniform(0.5, 2.0, nx)) for _ in range(c)]),
        q=np.stack([np.diag(rng.uniform(0.1, 0.5, nx)) for _ in range(c)]),
        r=np.stack([np.diag(rng.uniform(0.2, 0.5, ny)) for _ in range(c)]),
        z=rng.standard_normal((c, ny)))
    for kind in ("cubature", "unscented"):
        t0 = time.perf_counter()
        outs = []
        for dev in (torch.device("cpu"), device):
            a = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            pred = nkf.batched_predict(getattr(nkf, f"{kind}_predict"))
            upd = nkf.batched_update(getattr(nkf, f"{kind}_update"))
            xp, pp = pred(a["x"], a["p"], lambda v, m=a["f"]: m @ v, a["q"])
            xu, pu = upd(a["z"], xp, pp,
                         lambda v, m=a["h"]: torch.sin(m @ v), a["r"])
            outs.append([t.cpu().numpy() for t in (xp, pp, xu, pu)])
        err = max(float(np.max(np.abs(g - w) / (np.abs(w) + 1e-12)))
                  for g, w in zip(outs[1], outs[0]))
        ok = all(np.allclose(g, w, rtol=1e-5, atol=1e-12)
                 for g, w in zip(outs[1], outs[0]))
        _line("nonlinear_kf", t0, bank=kind, channels=c, state=nx,
              max_rel_err=f"{err:.3e}", ok=ok)
        if not ok:
            raise SystemExit(f"nonlinear_kf: the {kind} bank on {device} "
                             f"disagrees with the CPU ({err:.3e})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse phases 3, 4, 6, 8, 9 and 10 on the CPU "
                         "(plain versions)")
    ap.add_argument("--k2-baseline", type=pathlib.Path, default=None,
                    help="a checkout of the repository (the parent commit, "
                         "say) whose K2 is timed at the same shapes before "
                         "and after this one's")
    args = ap.parse_args(argv)

    from gnss_sdr_tpu_torch.ops import correlator

    if args.cpu:
        device = torch.device("cpu")
        phase_k1(device, correlator)
        phase_k2(device, with_k16=False)
        phase_cli(device, phase_main(device, 3.0, check_fix=False), 0.5)
        t0 = time.perf_counter()
        cap = hybrid_capture(3.0)
        _line("hybrid", t0, step="generate", samples=len(cap["x"]))
        hyb = phase_hybrid(device, cap, check=False)
        phase_cli_hybrid(device, cap, hyb, check=False)
        for signal in ("L5", "5X"):
            run_wideband(device, signal, check=False, duration_s=1.0)
        phase_k2_kf(device)
        phase_kf(device, phase_dynamic(device, 3.0, check=False),
                 check=False, cli=False)
        phase_sbas(device, sbas_capture(device, 3.0), check=False)
        for name in SIGNAL_RUNS:
            phase_signal(name, device, 3.0, check=False)
        phase_cli_rtk(device, phase_rtk(device, 4.0, check=False),
                      check=False)
        phase_conditioning(device)
        phase_cli_notch(device, 1.0, check=False)
        phase_cli_supl(device, phase_main(device, 3.0, check_fix=False), 3.0,
                       check=False)
        phase_cli_labsat3(device, 0.5, check=False)
        phase_front_end_cal(device)
        phase_sources(device)
        main_run = phase_main(device, 3.0, check_fix=False)
        phase_tcp(device, main_run, 1.0)
        phase_dumps(device, main_run, 1.0)
        del main_run
        cap = hybrid_capture(3.0)
        phase_e1_8ms(device, cap, phase_hybrid(device, cap, check=False))
        del cap
        phase_ms_dual_band(device, dual_band_capture(device, 2.0),
                           check=False, cli_s=1.0)
        phase_ms_gps_glonass(device, gps_glonass_capture(device, 2.0),
                             check=False)
        phase_nonlinear_kf(device)
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
    from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
    built = cuda_build.build_many(["correlator", "tracking",
                                   *tk.PART_BUILDS.values()])
    for name, info in built.items():
        for ln in info["report"].splitlines():
            if "ptxas" in ln or "error" in ln.lower():
                print(f"[build] {name}: {ln.strip()}")
        _line("build", t0, kernel=name, library=info["path"].name,
              nvcc_seconds=f"{info['seconds']:.3f}")

    correlator.launches = 0
    k1_err = phase_k1(device, correlator)
    k2_err = phase_k2(device, with_k16=True)
    phase_k2_clusters(device)
    kf_err = phase_k2_kf(device)
    timing = phase_timing(device, correlator, smi)
    timing_k2 = phase_timing_k2(device, smi, args.k2_baseline)
    timing_kf = phase_timing_kf(device, smi)
    k1_own = correlator.launches
    main_run = phase_main(device, 28.0, check_fix=True)
    rx, x = main_run["rx"], main_run["x"]
    k2_main, k1_main = main_run["k2_launches"], main_run["k1_launches"]
    k2_err = _worst(k2_err, phase_k2_case("final_carry", device,
                                          *_final_carry_case(rx, x)))
    phase_stream(device, x, main_run["prns"], 12.0)
    phase_profile(rx, x)
    cli_k2 = phase_cli(device, main_run, 2.0)
    # SUPL assistance on the main capture's first SUPL_DUR s
    cli_supl_k2 = phase_cli_supl(device, main_run)
    # TCP-connector tracking and the stage dumps on the main capture
    tcp = phase_tcp(device, main_run, 3.0)
    dumps_k2 = phase_dumps(device, main_run, SUPL_DUR)
    del main_run, rx, x

    t0 = time.perf_counter()
    cap = hybrid_capture(26.0, device)
    _line("hybrid", t0, step="generate", samples=len(cap["x"]),
          gps=sorted(cap["sc_g"].prns), gal=sorted(cap["sc_e"].prns))
    hyb = phase_hybrid(device, cap, check=True)
    for group, name in ((0, "hybrid_gps_final_carry"),
                        (1, "hybrid_gal_final_carry")):
        k2_err = _worst(k2_err, phase_k2_case(
            name, device, *_final_carry_case(hyb["rx"], cap["x"], group)))
    cli_hyb_k2 = phase_cli_hybrid(device, cap, hyb, check=True)
    e1_8ms_k2 = phase_e1_8ms(device, cap, hyb)
    hyb_k1, hyb_k2 = hyb["k1_launches"], hyb["k2_launches"]
    del cap, hyb
    wide = {}
    for signal in ("L5", "5X"):
        wide[signal] = run_wideband(device, signal, check=True)
        k2_err = _worst(k2_err, wide[signal]["k2_err"])
    # the later slices' receivers: the moving GPS L1 receiver, GPS L2C,
    # BeiDou B1I, GLONASS L1 / L2 and BeiDou B3I, each with K2 on its final
    # carry; the shipped confs through the CLI (GLONASS's on captures of
    # their own, GLO_CLI)
    runs = {}
    for name, dur, conf, fs, cli_s in (
            ("dynamic", 28.0, None, FS, 0.0),
            ("l2c", 58.0, "gps_l2c.conf", L2C_FS, 8.0),
            ("b1i", 30.0, "beidou_b1i.conf", B1I_FS, 6.0),
            ("glo_l1", None, "glonass_l1.conf", 9.0e6, 4.0),
            ("glo_l2", None, "glonass_l2.conf", GLO2_FS, 4.0),
            ("b3i", 30.0, "beidou_b3i.conf", B3I_FS, 4.0)):
        run = (phase_dynamic(device, dur, check=True) if name == "dynamic"
               else phase_signal(name, device, dur, check=True))
        k2_err = _worst(k2_err, phase_k2_case(
            f"{name}_final_carry", device,
            *_final_carry_case(run["rx"], run["x"])))
        if name == "dynamic":
            # the Kalman carrier loop on the dynamic capture
            kf = phase_kf(device, run, check=True)
            kf_err = _worst(kf_err, kf["k2_err"])
        cli_run = run
        if conf in GLO_CLI:
            del run["x"]
            cli_run = glonass_cli_capture(device, conf, fs, cli_s)
        runs[name] = dict(k2=run["k2_launches"], k1=run["k1_launches"],
                          cli_k2=(phase_cli_shipped(device, cli_run, conf, fs,
                                                    cli_s) if conf else None))
        del run, cli_run

    # SBAS L1: tests/test_e2e_sbas.py's corrections off and on
    sbas = phase_sbas(device, sbas_capture(device, SBAS_DUR), check=True)
    # the RTK rover on the receiver's carrier phase (tests/test_e2e_rtk.py),
    # then conf/rtk_rover_ntrip.conf through the CLI against a local caster
    rtk = phase_rtk(device, RTK_DUR, check=True, smi=smi)
    cli_rtk_k2 = phase_cli_rtk(device, rtk, check=True)
    rtk_k1, rtk_k2 = rtk["k1_launches"], rtk["k2_launches"]
    del rtk
    # input conditioning, the notch and LabSat confs, front-end
    # calibration and the remaining signal sources
    phase_conditioning(device)
    cli_notch_k2 = phase_cli_notch(device)
    cli_labsat3_k2 = phase_cli_labsat3(device)
    phase_front_end_cal(device)
    sources_k2 = phase_sources(device)
    # the multi-source receiver: dual-band L1 + L5 with PPP on its merged
    # observables (and its CLI run), then GPS + GLONASS; the sigma-point
    # filter banks
    ms = phase_ms_dual_band(device, dual_band_capture(device, MS_DUR),
                            check=True)
    glo = phase_ms_gps_glonass(device, gps_glonass_capture(device, None),
                               check=True)
    k2_err = _worst(_worst(k2_err, ms["k2_err"]), glo["k2_err"])
    phase_nonlinear_kf(device)

    a, k2c8 = timing["a_main_path"], timing_k2["k2_c8"]
    kf8 = timing_kf["k2_kf_c8"]
    e1p = timing_k2["k2_e1p_c6"]
    l5t, e5at = timing_k2["k2_l5_c4"], timing_k2["k2_e5ap_c4"]
    record = {"kernels": [{
        "name": "epoch_multicorrelator",
        "route": "cuda",
        "source": "gnss_sdr_tpu_torch/csrc/correlator.cu",
        "replaces": "gnss_sdr_tpu/ops/correlator_pallas.py:70",
        "launches": k1_own,
        "main_path_launches": k1_main,
        "hybrid_launches": hyb_k1,
        "l5_launches": wide["L5"]["k1_launches"],
        "e5a_launches": wide["5X"]["k1_launches"],
        **{f"{name}_launches": r["k1"] for name, r in runs.items()},
        "rtk_launches": rtk_k1,
        "tcp_launches": tcp["k1_launches"],
        "tcp_max_abs_err": tcp["k1_err"],
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
        "launches": hyb_k2,
        "gps_main_launches": k2_main,
        "cli_launches": cli_k2,
        "cli_hybrid_launches": cli_hyb_k2,
        "max_abs_err": k2_err["max_abs_err"],
        "float_tol_ratio": k2_err["float_tol_ratio"],
        "prompt_tol_ratio": k2_err["prompt_tol_ratio"],
        "ms": k2c8["ms"],
        "plain_ms": k2c8["plain_ms"],
        "bound_ms": k2c8["bound_ms"],
        "bound_by": k2c8["bound_by"],
        "cluster": k2c8["cluster"],
        "m1_ms": k2c8["m1_ms"],
        "shapes": {name: {k: r[k] for k in ("ms", "m1_ms", "cluster",
                                            "bound_ms", "bound_by",
                                            "plain_ms")}
                   for name, r in timing_k2.items()},
        "e1_pilot_ms": e1p["ms"],
        "e1_pilot_plain_ms": e1p["plain_ms"],
        "e1_pilot_bound_ms": e1p["bound_ms"],
        "e1_pilot_bound_by": e1p["bound_by"],
        "l5_launches": wide["L5"]["k2_launches"],
        "cli_l5_launches": wide["L5"]["cli_k2"],
        "l5_ms": l5t["ms"],
        "l5_plain_ms": l5t["plain_ms"],
        "l5_bound_ms": l5t["bound_ms"],
        "l5_bound_by": l5t["bound_by"],
        "e5a_launches": wide["5X"]["k2_launches"],
        "cli_e5a_launches": wide["5X"]["cli_k2"],
        "e5a_pilot_ms": e5at["ms"],
        "e5a_pilot_plain_ms": e5at["plain_ms"],
        "e5a_pilot_bound_ms": e5at["bound_ms"],
        "e5a_pilot_bound_by": e5at["bound_by"],
        **{f"{name}_launches": r["k2"] for name, r in runs.items()},
        **{f"cli_{name}_launches": runs[name]["cli_k2"]
           for name in ("l2c", "b1i", "glo_l1", "glo_l2", "b3i")},
        **{f"{name}_{k}": timing_k2[shape][k]
           for name, shape in (("dynamic", "k2_dyn_c6"), ("l2c", "k2_l2c_c5"),
                               ("b1i", "k2_b1i_c4"), ("glo_l1", "k2_glo1_c5"),
                               ("glo_l2", "k2_glo2_c4"), ("b3i", "k2_b3i_c4"))
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "sbas_launches": sbas["k2_launches"],
        "rtk_launches": rtk_k2,
        "cli_rtk_launches": cli_rtk_k2,
        "cli_notch_launches": cli_notch_k2,
        "cli_supl_launches": cli_supl_k2,
        "cli_labsat3_launches": cli_labsat3_k2,
        "sources_uhd_mock_launches": sources_k2,
        "tcp_launches": tcp["k2_launches"],
        "dumps_launches": dumps_k2,
        "e1_8ms_launches": e1_8ms_k2,
        "ms_dual_band_l1_launches": ms["l1_launches"],
        "ms_dual_band_l5_launches": ms["l5_launches"],
        "cli_multisource_launches": ms["cli_launches"],
        "ms_gps_glonass_gps_launches": glo["gps_launches"],
        "ms_gps_glonass_glo_launches": glo["glo_launches"],
        "library_ms": None,
    }, {
        "name": "tracking_chunk_kf",
        "route": "cuda",
        "source": "gnss_sdr_tpu_torch/csrc/tracking.cu",
        "replaces": "gnss_sdr_tpu/receiver/tracking.py:432",
        "kf_branch": "gnss_sdr_tpu/receiver/tracking.py:529",
        "variant": "track_chunk_kernel<kPilot, kTaps, true>",
        "launches": kf["kf_launches"],
        "ramp_launches": kf["ramp_kf_launches"],
        "cli_launches": kf["cli_kf_launches"],
        "max_abs_err": kf_err["max_abs_err"],
        "float_tol_ratio": kf_err["float_tol_ratio"],
        "prompt_tol_ratio": kf_err["prompt_tol_ratio"],
        "ms": kf8["ms"],
        "plain_ms": kf8["plain_ms"],
        "bound_ms": kf8["bound_ms"],
        "bound_by": kf8["bound_by"],
        "non_kf_ms": kf8["non_kf_ms"],
        "shapes": {name: {k: r[k] for k in (
            "ms", "non_kf_ms", "cluster", "bound_ms", "bound_by",
            "plain_ms", "kf_updates")} for name, r in timing_kf.items()},
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
