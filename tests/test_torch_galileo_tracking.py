"""Galileo E1 tracking in the port against the JAX package, on the CPU.

- The plain multicorrelator with ``tap_components`` (a [C, 2, Lt] table,
  tap k read from component k's entry) against JAX ``batch_epoch_correlate``
  (its gather path), as complex values: |dz| <= 1e-4 |z| + 1e-4 (the two
  sum ~16,000 samples in different orders).
- The eager loop (K2's plain version) open loop from the identical carry
  against JAX ``track_chunk`` on one 27-step chunk of generated Galileo E1
  at 4 MSps (BOC(1,1) tables, VEML taps): E1-B alone, E1-C pilot tracking
  with the E1-B data prompt, and pilot tracking with extended integration
  and the CS25 wipe on two channels. The int32 fields are equal at every
  step; float fields within rtol / atol 1e-4, correlator sums (the
  prompt, every tap, the carry's coherent accumulator) as complex values as
  above (tests/test_torch_tracking.py's tolerances).
- The same loop fed JAX's own correlator sums (``correlate=``) keeps
  JAX's bits in every field that feeds an int field.
- ``track_multi_packed`` (GPS L1 C/A at 4 MSps and E1 with pilot on one
  shared chunk, each on its slab) against JAX's, the int32 columns 9-11
  compared exactly (JAX's own test masks them).
- K2's wrapper at the E1 pilot shape: the parameter block, the checks, and
  a shared-memory footprint that does not grow with n_max.

The ``gpu`` test holds K2 to the eager loop on the card bit for bit at
these shapes; it needs no JAX, so JAX is imported by the tests that use
it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch.ops import correlator as tcorr
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.utils import scenario

torch.set_num_threads(1)   # one thread per xdist worker

INT_FIELDS = ("valid", "state", "n_samples", "start_offset", "epoch_index",
              "carr_phase_cycles")
FLOAT_FIELDS = ("rem_code_phase", "code_freq", "carrier_freq",
                "carr_phase_frac", "cn0_dbhz", "carrier_lock")
CASES = {"e1b": dict(signal="1B"),
         "pilot": dict(signal="1B", pilot=True),
         "pilot_extended": dict(signal="1B", pilot=True, extended=True)}


def _jax_state(st):
    """The JAX package's TrackingState holding the port carry ``st``."""
    from gnss_sdr_tpu.ops import cn0 as jcn0
    from gnss_sdr_tpu.ops import loop_filters as jlf
    from gnss_sdr_tpu.receiver import tracking as jtrk

    n = ttrk.state_to_numpy(st)
    nested = {"dll": jlf.Loop2State, "pll": jlf.Loop3State,
              "cn0": jcn0.Cn0State}
    return jtrk.TrackingState(**{
        k: nested[k](*getattr(n, k)) if k in nested else getattr(n, k)
        for k in jtrk.TrackingState._fields})


def _jax_cfg(cfg):
    from gnss_sdr_tpu.receiver import tracking as jtrk

    return jtrk.TrackingConfig(**dataclasses.asdict(cfg))


def _complex_close(a, b):
    za, zb = a[..., 0] + 1j * a[..., 1], b[..., 0] + 1j * b[..., 1]
    bad = np.abs(zb - za) > 1e-4 * np.abs(za) + 1e-4
    assert not bad.any(), np.argwhere(bad)[:5]


def moment_bounds(ema_i2_plus_q2, e, eps=1e-4):
    """Bounds on the C/N0 moments' difference from JAX's when every prompt
    P in them lies within |dP| <= e |P| + eps of JAX's: with s^2 =
    ``ema_i2_plus_q2`` (the EMA of |P|^2) and d = e s + eps,
    |d ema_i2_minus_q2| <= d (2 s + d) and |d ema_abs_i| <= d
    (tests/test_torch_tracking.py derives them)."""
    s = np.sqrt(np.asarray(ema_i2_plus_q2, np.float64))
    d = e * s + eps
    return {"ema_i2_minus_q2": d * (2 * s + d), "ema_abs_i": d}


def jax_correlate(chunk, offsets, n_samples, code_tables, *params,
                  n_max, table_rate=1, tap_components=None):
    """A ``correlate=`` for the port's eager loop that returns the JAX
    package's correlator sums (``batch_epoch_correlate``, its gather path)
    on the loop's own inputs: fed these, the loop shows what the sums' order
    alone does to it."""
    import jax.numpy as jnp
    from gnss_sdr_tpu.ops import correlator as jcorr

    args = (chunk, offsets, n_samples, code_tables) + params
    out = jcorr.batch_epoch_correlate(
        *(jnp.asarray(t.numpy()) for t in args), n_max=n_max,
        table_rate=table_rate, tap_components=tap_components)
    return torch.from_numpy(np.array(out))


# fed JAX's sums, the fields that keep other roundings than the
# reference's: two reported floats (its log10, its division) and the DLL
# integrator (w0 = Bn / 0.53: XLA multiplies by the reciprocal, the eager
# loop on the CPU divides); none of them is floored into an int field
FED_OTHER_ROUNDING = ("cn0_dbhz", "carrier_lock", "dll.acc1")


def assert_fed_jax_sums_keep_bits(jst, jout, tst, tout):
    """Every output field and carry field of the port's loop, fed JAX's
    sums, holds JAX's bits but those of FED_OTHER_ROUNDING."""
    for f in tout._fields:
        if f in FED_OTHER_ROUNDING:
            continue
        a, b = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.int32) if a.dtype == np.float32 else a,
            b.view(np.int32) if b.dtype == np.float32 else b), f
    tst = ttrk.state_to_numpy(tst)
    for name in ttrk.TrackingState._fields:
        a, b = getattr(jst, name), getattr(tst, name)
        for field, x, y in (zip(a._fields, a, b)
                            if name in ("dll", "pll", "cn0")
                            else [(name, a, b)]):
            if f"{name}.{field}" not in FED_OTHER_ROUNDING:
                np.testing.assert_array_equal(y, np.asarray(x),
                                              err_msg=f"{name}.{field}")


def test_plain_correlator_tap_components_match_jax():
    jnp = pytest.importorskip("jax.numpy")
    from gnss_sdr_tpu.ops import correlator as jcorr

    rng = np.random.default_rng(31)
    n_ch, n_max, lt = 4, 16064, 8184
    length = 4 * n_max
    taps = np.array([-0.6, -0.15, 0.0, 0.15, 0.6, 0.0], np.float32)
    comps = (0, 0, 0, 0, 0, 1)
    args = dict(
        chunk=rng.standard_normal((length, 2)).astype(np.float32),
        offsets=rng.integers(0, length - n_max, n_ch).astype(np.int32),
        n_samp=np.array([15990, 16003, 0, 16064], np.int32),
        codes=rng.choice([-1.0, 1.0], (n_ch, 2, lt)).astype(np.float32),
        rem=rng.uniform(0.0, 0.6, n_ch).astype(np.float32),
        cps=(1.023e6 * (1 + rng.uniform(-3e-6, 3e-6, n_ch)) / 4e6
             ).astype(np.float32),
        frac=rng.uniform(0.0, 1.0, n_ch).astype(np.float32),
        step=rng.uniform(-1.2e-3, 1.2e-3, n_ch).astype(np.float32),
        taps=taps)
    got = tcorr.batch_epoch_correlate(
        *(torch.from_numpy(v) for v in args.values()), n_max=n_max,
        table_rate=2, tap_components=comps).numpy()
    want = np.asarray(jcorr.batch_epoch_correlate(
        *(jnp.asarray(v) for v in args.values()), n_max=n_max,
        table_rate=2, tap_components=comps))
    assert got.shape == (n_ch, 6, 2)
    _complex_close(want, got)
    assert not got[2].any()                       # n_samples = 0
    # component 1 is the data table: the data tap equals the prompt tap of
    # a single-component correlation on that table
    one = tcorr.batch_epoch_correlate(
        *(torch.from_numpy(v) for v in dict(
            args, codes=np.ascontiguousarray(args["codes"][:, 1]),
            taps=taps[2:3]).values()), n_max=n_max, table_rate=2).numpy()
    np.testing.assert_array_equal(got[:, 5], one[:, 0])


@pytest.fixture(scope="module", params=sorted(CASES))
def open_loop(request):
    import jax.numpy as jnp
    from gnss_sdr_tpu.receiver import tracking as jtrk

    c = scenario.tracking_handoff_case("cpu", **CASES[request.param])
    cfg, sec = c["cfg"], c["sec"]
    jst, jout = jtrk.track_chunk(
        _jax_cfg(cfg), jnp.asarray(c["chunk"]), _jax_state(c["state"]),
        jnp.asarray(c["tables"]), None if sec is None else jnp.asarray(sec))
    tst, tout = ttrk.track_chunk(
        cfg, torch.from_numpy(c["chunk"]), c["state"],
        torch.from_numpy(c["tables"]),
        None if sec is None else torch.from_numpy(sec))
    return dict(name=request.param, cfg=cfg, jst=jst, jout=jout, tst=tst,
                tout=tout, case=c)


def run_fed_jax_sums(open_loop):
    """The port's eager loop on the fixture's case, fed JAX's sums."""
    c = open_loop["case"]
    sec = None if c["sec"] is None else torch.from_numpy(c["sec"])
    return ttrk.track_chunk(open_loop["cfg"], torch.from_numpy(c["chunk"]),
                            c["state"], torch.from_numpy(c["tables"]), sec,
                            correlate=jax_correlate)


def test_fed_jax_sums_keep_jax_bits(open_loop):
    """Fed JAX's correlator sums, the port's loop keeps JAX's bits in every
    field but FED_OTHER_ROUNDING: what is left of the difference the other
    tests bound is the sums' summation order."""
    tst, tout = run_fed_jax_sums(open_loop)
    assert_fed_jax_sums_keep_bits(open_loop["jst"], open_loop["jout"], tst,
                                  tout)


def test_open_loop_matches_jax(open_loop):
    cfg, jout, tout = open_loop["cfg"], open_loop["jout"], open_loop["tout"]
    assert cfg.n_steps == 27 and cfg.n_max == 16064 and cfg.table_rate == 2
    assert cfg.n_taps == (6 if cfg.track_pilot else 5)
    for f in INT_FIELDS:
        a = np.asarray(getattr(jout, f))
        b = getattr(tout, f).numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), f"{f}: first (step, channel) differing {bad[:5]}"
    assert np.asarray(jout.valid)[:, :5].sum() >= 120
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("prompt", "correlators"):
        _complex_close(np.asarray(getattr(jout, f)),
                       getattr(tout, f).numpy())
    # under pilot tracking the packed prompt is the data (E1-B) tap
    np.testing.assert_array_equal(
        tout.prompt.numpy(),
        tout.correlators.numpy()[:, :, cfg.data_prompt_index])
    jst, tst = open_loop["jst"], ttrk.state_to_numpy(open_loop["tst"])
    # the coherent accumulator holds correlator sums: complex values
    _complex_close(np.asarray(jst.acc_corr), tst.acc_corr)
    for name in ttrk.TrackingState._fields:
        if name == "acc_corr":
            continue
        a, b = getattr(jst, name), getattr(tst, name)
        for x, y in (zip(a, b) if name in ("dll", "pll", "cn0")
                     else [(a, b)]):
            x = np.asarray(x)
            if x.dtype.kind in "biu":
                np.testing.assert_array_equal(y, x, err_msg=name)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4,
                                           err_msg=name)
    if open_loop["name"] == "pilot_extended":
        assert tst.ext_n[[1, 3]].tolist() == [5, 5] and tst.sec_len[3] == 25


def _two_groups():
    g = scenario.tracking_handoff_case("cpu", signal="1C", fs=4.0e6)
    e = scenario.tracking_handoff_case("cpu", signal="1B", pilot=True,
                                       seed=12)
    chunk = e["chunk"].copy()
    chunk[: len(g["chunk"])] += g["chunk"]
    return g, e, chunk


def test_track_multi_packed_matches_jax():
    import jax.numpy as jnp
    from gnss_sdr_tpu.receiver import tracking as jtrk

    g, e, chunk = _two_groups()
    cfgs = (g["cfg"], e["cfg"])
    slabs = tuple(c.chunk_len + c.n_max for c in cfgs)
    assert slabs[1] == len(chunk) and slabs[0] < slabs[1]
    sec = np.ones((6, 32), np.float32)
    jnew, jflat = jtrk.track_multi_packed(
        tuple(_jax_cfg(c) for c in cfgs), jnp.asarray(chunk),
        (_jax_state(g["state"]), _jax_state(e["state"])),
        (jnp.asarray(g["tables"]), jnp.asarray(e["tables"])),
        (jnp.asarray(sec), jnp.asarray(sec)), (slabs[0], None))
    tnew, tflat = ttrk.track_multi_packed(
        cfgs, torch.from_numpy(chunk), (g["state"], e["state"]),
        (torch.from_numpy(g["tables"]), torch.from_numpy(e["tables"])),
        (torch.from_numpy(sec), torch.from_numpy(sec)), (slabs[0], None))
    jflat, tflat = np.asarray(jflat), tflat.numpy()
    assert tflat.shape == jflat.shape
    off = 0
    for cfg in cfgs:
        n = cfg.n_steps * 6 * 13
        jp = jflat[off: off + n].reshape(cfg.n_steps, 6, 13)
        tp = tflat[off: off + n].reshape(cfg.n_steps, 6, 13)
        off += n
        jf, ji, jl = jtrk.unpack_host_outputs(jp)
        tf, ti, tl = ttrk.unpack_host_outputs(tp)
        np.testing.assert_array_equal(ti, ji)      # columns 9-11, exactly
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tf[..., 8], jf[..., 8])
        np.testing.assert_allclose(tf[..., 2:8], jf[..., 2:8], rtol=1e-4,
                                   atol=1e-4)
        _complex_close(jf[..., :2], tf[..., :2])
    for js, ts in zip(jnew, tnew):
        np.testing.assert_array_equal(ttrk.state_to_numpy(ts).sample_offset,
                                      np.asarray(js.sample_offset))
        np.testing.assert_array_equal(ttrk.state_to_numpy(ts).epoch_count,
                                      np.asarray(js.epoch_count))
    # the packed carry form comes back packed, group by group
    packed, _ = ttrk.track_multi_packed(
        cfgs, torch.from_numpy(chunk),
        (tk.pack_carry(g["state"]), tk.pack_carry(e["state"])),
        (torch.from_numpy(g["tables"]), torch.from_numpy(e["tables"])),
        (None, None), (slabs[0], None))
    for p, s in zip(packed, tnew):
        assert torch.equal(p, tk.pack_carry(s))


def test_k2_wrapper_at_the_e1_pilot_shape():
    c = scenario.tracking_handoff_case("cpu", signal="1B", pilot=True)
    cfg = c["cfg"]
    carry = tk.pack_carry(c["state"])
    assert carry.shape == (6, tk.carry_width(6))
    good = dict(chunk=torch.from_numpy(c["chunk"]), carry=carry,
                code_tables=torch.from_numpy(c["tables"]), sec_tables=None)
    tk._check(cfg, **good)
    p = tk.make_params(cfg, 6, len(c["chunk"]), 8184, 0)
    assert (p.n_taps, p.n_comp, p.prompt_index, p.data_prompt_index) == \
        (6, 2, 2, 5)
    assert list(p.tap_comp)[:6] == [0, 0, 0, 0, 0, 1]
    assert list(p.taps)[:6] == [np.float32(t) for t in
                                (-0.6, -0.15, 0.0, 0.15, 0.6, 0.0)]
    assert p.tile == tk.TILE_MAX and p.tile % tcorr.BLOCK_THREADS == 0
    # the ring is two tiles whatever the window: 16,064 samples (E1 at
    # 4 MSps) and 12,064 (L5 / E5a at 12 MSps) take no more than 4,064
    assert tk.shared_bytes(16064, 8184, 2) == 2 * 4096 * 8 + 2 * 8184 * 4
    assert tk.shared_bytes(16064, 8184, 2) < tk.MAX_SMEM_BYTES
    assert tk.shared_bytes(12064, 10230, 2) == tk.shared_bytes(4064, 10230, 2)
    assert tk.tile_len(2064) == 2560 and tk.tile_len(512) == 512
    bad_cases = [dict(code_tables=good["code_tables"][:, 0].contiguous()),
                 dict(code_tables=torch.ones((6, 3, 8184))),
                 dict(carry=tk.pack_carry(ttrk.init_state(6, 5,
                                                          device="cpu")))]
    for change in bad_cases:
        with pytest.raises(ValueError):
            tk._check(cfg, **dict(good, **change))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_eager_plain_e1(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda", 0)
    c = scenario.tracking_handoff_case(dev, **CASES[case])
    cfg, state = c["cfg"], c["state"]
    chunk = torch.from_numpy(c["chunk"]).to(dev)
    tables = torch.from_numpy(c["tables"]).to(dev)
    sec = None if c["sec"] is None else torch.from_numpy(c["sec"]).to(dev)
    before = tk.launches
    new, packed = ttrk.track_chunk_packed(cfg, chunk, state, tables, sec)
    assert tk.launches == before + 1
    ref_state, out = ttrk.track_chunk(
        cfg, chunk, state, tables, sec,
        correlate=tcorr.epoch_correlate_plain)
    ref = ttrk.pack_host_outputs(out, ref_state.loss_of_lock)
    torch.cuda.synchronize()
    assert torch.equal(packed.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(tk.pack_carry(new), tk.pack_carry(ref_state))
