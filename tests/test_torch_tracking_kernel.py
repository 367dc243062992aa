"""The fused tracking kernel's wrapper (gnss_sdr_tpu_torch.ops.tracking_kernel)
and the CPU path of ``track_chunk_packed``.

On the CPU: the packed carry round-trips every ``TrackingState`` field
exactly; its layout and the kernel's parameter block are those of
csrc/tracking.cu; ``track_chunk_packed`` (the eager loop, K2's plain
version, which sums each window in the kernels' block order) still equals
the JAX package's ``track_chunk_packed`` on the extended-integration handoff
case, int32 columns exactly and float columns within rtol 1e-4 / atol 1e-4
(the prompt as a complex number: |dz| <= 1e-4 |z| + 1e-4, see
tests/test_torch_tracking.py), and on the plain handoff of other seeds
its int columns, int carry fields and packed float columns too; the
wrapper's checks refuse what the kernel does not take. The ``gpu`` test runs
K2 against the eager loop with the plain correlator on the card, at the same
tolerances; it needs no JAX (the card's machine has none), so JAX is
imported by the tests that use it.

Run as a script, the file prints, for each seed given (default 1-8 and
11) and each handoff case, how far the CPU path lies from the JAX package
in units of the rtol / atol 1e-4 bound:

    PYTHONPATH=. python tests/test_torch_tracking_kernel.py [SEED ...]

and with ``--profile`` the eager loop's host operations per step and its
seconds per chunk at the L5 shape (PERF.md's eager-loop profile); with
``--profile-against DIR`` the eager loop of one chunk at the L5, GPS L1,
E1 pilot and L2C shapes, in one process, on this checkout's plain
correlator, on the plain correlator of the checkout in DIR (the parent
commit's, say) and on zeros, in turns (least of 5 each), with the
correlator's share of the chunk.
"""

import ctypes
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.ops import correlator
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.utils import scenario

torch.set_num_threads(1)   # one thread per xdist worker

FS = 2.0e6
CSRC = pathlib.Path(tk.__file__).resolve().parents[1] / "csrc"


def _fields(state):
    """(name, numpy array) for every leaf of a carry."""
    st = ttrk.state_to_numpy(state) if isinstance(state.active, torch.Tensor) \
        else state
    for name in ttrk.TrackingState._fields:
        v = getattr(st, name)
        if name in ("dll", "pll", "cn0"):
            for sub, x in zip(v._fields, v):
                yield f"{name}.{sub}", np.asarray(x)
        else:
            yield name, np.asarray(v)


def _assert_carry_close(got, want, exact_floats=False):
    for (name, a), (_, b) in zip(_fields(got), _fields(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "biu" or exact_floats:
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=name)


def _assert_packed_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    f_g, i_g, lol_g = ttrk.unpack_host_outputs(got)
    f_w, i_w, lol_w = ttrk.unpack_host_outputs(want)
    np.testing.assert_array_equal(i_g, i_w)
    np.testing.assert_array_equal(lol_g, lol_w)
    np.testing.assert_array_equal(f_g[..., 8], f_w[..., 8])      # valid
    np.testing.assert_allclose(f_g[..., 2:8], f_w[..., 2:8], rtol=1e-4,
                               atol=1e-4)
    zg = f_g[..., 0] + 1j * f_g[..., 1]
    zw = f_w[..., 0] + 1j * f_w[..., 1]
    bad = np.abs(zg - zw) > 1e-4 * np.abs(zw) + 1e-4
    assert not bad.any(), f"prompt: {np.argwhere(bad)[:5]}"


def _leaves(state):
    for v in state:
        yield from (v if isinstance(v, tuple) else (v,))


def test_carry_roundtrip_exact():
    jtrk = pytest.importorskip("gnss_sdr_tpu.receiver.tracking")
    js = jtrk.init_state(5, 3)
    js = jtrk.start_channel(js, 2, code_freq=1.0231e6, doppler_hz=-1500.0,
                            sample_offset=77, rem_code_phase=0.25)
    js = jtrk.start_channel(js, 4, code_freq=1.0229e6, doppler_hz=3100.0,
                            sample_offset=-5, rem_code_phase=0.1)
    js = jtrk.set_extension(js, 2, 20, 13)
    js = jtrk.set_secondary(js, np.ones((5, 32), np.float32), 4,
                            [0, 1, 1, 0], 5)
    st = ttrk.state_from_numpy(js, "cpu")
    buf = tk.pack_carry(st)
    assert buf.dtype == torch.int32
    assert tuple(buf.shape) == (5, tk.carry_width(3))
    back = tk.unpack_carry(buf, st)
    _assert_carry_close(back, st, exact_floats=True)
    _assert_carry_close(back, js, exact_floats=True)
    assert all(t.is_contiguous() for t in _leaves(back))


def test_carry_layout_matches_kernel():
    """The packed carry's words and the parameter block are laid out as
    csrc/tracking.cu reads them."""
    src = (CSRC / "tracking.cu").read_text()
    enum = re.search(r"enum CarryWord \{(.*?)\};", src, re.S).group(1)
    words = re.findall(r"W_([A-Z0-9_]+)", enum)
    want = [f.replace(".", "_").upper() for f in tk.CARRY_FIELDS]
    assert words == want + ["ACC_CORR"]
    body = re.search(r"struct TrackParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip().split("[")[0] for n in
                      decl.split(None, 1)[1].split(",")]
    assert names == [n for n, _ in tk._Params._fields_]


def test_cluster_field_follows_the_tile():
    """TrackParams carries the cluster size m after the tile length, an int
    (the layout test above holds the whole order); make_params fills it."""
    names = [n for n, _ in tk._Params._fields_]
    assert names[names.index("tile") + 1] == "cluster"
    assert dict(tk._Params._fields_)["cluster"] is ctypes.c_int
    cfg = ttrk.default_config(constants.GPS_L1_CA, FS, 100)
    assert tk.make_params(cfg, 8, 1, 1023, 0).cluster == 1
    assert tk.make_params(cfg, 8, 1, 1023, 0, 4).cluster == 4
    # each block of a cluster holds its lanes' share of the ring
    assert tk.shared_bytes(cfg.n_max, 1023, 1, 4) == \
        2 * (tk.tile_len(cfg.n_max) // 4) * 8 + 1023 * 4


@pytest.mark.parametrize("n_ch, n_max, room, want", [
    (4, 11064, {8: 16, 4: 33, 2: 66}, 8),   # L5: every channel on 8 SMs
    (6, 16064, {8: 16, 4: 33, 2: 66}, 8),   # E1 pilot
    (8, 2064, {8: 16, 4: 33, 2: 66}, 1),    # GPS L1: too few samples
    (6, 4064, {8: 16, 4: 33, 2: 66}, 1),    # GPS L1 at 4 MSps
    (128, 12064, {8: 16, 4: 33, 2: 66}, 1),  # C=128 fills the card at m=1
    (17, 12064, {8: 20, 4: 33, 2: 66}, 4),  # 17 x 8 blocks > 132 SMs
    (20, 12064, {8: 16, 4: 33, 2: 66}, 4),
    (40, 12064, {8: 16, 4: 33, 2: 66}, 2),
    (4, 12064, {8: 2, 4: 4, 2: 8}, 4),      # large shared memory
    (1, 12064, {8: 0, 4: 0, 2: 0}, 1)])     # no cluster fits: one block
def test_cluster_choice(n_ch, n_max, room, want):
    """m is 1 below CLUSTER_MIN_SAMPLES samples per window, else the
    largest cluster size that puts at most one block on each of the card's
    132 SMs and at which every channel's cluster runs at once (the card's
    room for clusters at each m)."""
    assert tk.pick_cluster(n_ch, n_max, room.__getitem__, 132) == want


def test_check_refuses_a_bad_cluster_size():
    """m must split the 16 warps of a channel's lanes into whole warps, at
    most 8 blocks: 3, 16 and 0 are refused before any launch."""
    cfg = ttrk.default_config(constants.GPS_L1_CA, FS, 100)
    n = cfg.chunk_len + cfg.n_max
    good = dict(chunk=torch.zeros((n, 2)),
                carry=tk.pack_carry(ttrk.init_state(3, device="cpu")),
                code_tables=torch.ones((3, 1023)), sec_tables=None)
    for m in tk.CLUSTER_SIZES + (None,):
        tk._check(cfg, **good, cluster=m)
    for m in (0, 3, 16, -1):
        with pytest.raises(ValueError, match="cluster size"):
            tk._check(cfg, **good, cluster=m)
    before = tk.launches
    with pytest.raises(ValueError, match="cluster size"):
        tk.track_chunk_carry(cfg, good["chunk"], good["carry"],
                             good["code_tables"], cluster=3)
    assert tk.launches == before


@pytest.fixture(scope="module")
def handoff():
    return scenario.tracking_handoff_case("cpu", extended=True)


def _both(case):
    """The handoff ``case`` through the JAX package's and the port's
    ``track_chunk_packed`` on the CPU -> (port carry, port packed [S, C, 13],
    JAX carry (numpy), JAX packed)."""
    import jax.numpy as jnp
    from gnss_sdr_tpu.receiver import tracking as jtrk

    cfg, state = case["cfg"], case["state"]
    host = ttrk.state_to_numpy(state)
    jst = jtrk.init_state(state.active.shape[0], cfg.n_taps)
    jst = jtrk.TrackingState(**{
        name: (type(getattr(jst, name))(*(jnp.asarray(x) for x in v))
               if name in ("dll", "pll", "cn0") else jnp.asarray(v))
        for name, v in zip(ttrk.TrackingState._fields, host)})
    jcfg = jtrk.TrackingConfig(**dataclasses.asdict(cfg))
    sec = case["sec"]
    jnew, jpacked = jtrk.track_chunk_packed(
        jcfg, jnp.asarray(case["chunk"]), jst, jnp.asarray(case["tables"]),
        None if sec is None else jnp.asarray(sec))
    new, packed = ttrk.track_chunk_packed(
        cfg, torch.from_numpy(case["chunk"]), state,
        torch.from_numpy(case["tables"]),
        None if sec is None else torch.from_numpy(sec))
    jnew = jtrk.TrackingState(*(
        type(v)(*map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v)
        for v in jnew))
    return new, packed.numpy(), jnew, np.asarray(jpacked)


def test_packed_cpu_matches_jax(handoff):
    pytest.importorskip("gnss_sdr_tpu.receiver.tracking")
    new, packed, jnew, jpacked = _both(handoff)
    _assert_packed_close(packed, jpacked)
    _assert_carry_close(new, jnew)
    valid = packed[..., 8] > 0.5
    assert valid[:, :5].sum() > 400 and not valid[:, 5].any()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_packed_cpu_matches_jax_across_seeds(seed):
    """Other draws of the handoff's noise: the int columns, valid, the loss
    flag and every int / bool carry field equal, the packed float columns and
    the prompt within the rtol / atol 1e-4 bound. (The carry's float fields
    are held only at seed 11, above: on other seeds the EMA of I^2 - Q^2, a
    difference of two large sums during pull-in, lies up to ~30x the bound
    from the JAX package's in either summation order; PERF.md.)"""
    pytest.importorskip("gnss_sdr_tpu.receiver.tracking")
    case = scenario.tracking_handoff_case("cpu", seed=seed)
    new, packed, jnew, jpacked = _both(case)
    _assert_packed_close(packed, jpacked)
    for (name, a), (_, b) in zip(_fields(new), _fields(jnew)):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_track_chunk_takes_a_correlator():
    cfg = ttrk.default_config(constants.GPS_L1_CA, FS, 2)
    state = ttrk.start_channel(ttrk.init_state(2, device="cpu"), 0,
                               code_freq=1.023e6, doppler_hz=500.0,
                               sample_offset=3)
    chunk = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (cfg.chunk_len + cfg.n_max, 2)).astype(np.float32))
    tables = torch.ones((2, 1023))
    calls = []

    def plain(*a, **kw):
        calls.append(1)
        return correlator.epoch_correlate_plain(*a, **kw)

    st_a, out_a = ttrk.track_chunk(cfg, chunk, state, tables, correlate=plain)
    st_b, out_b = ttrk.track_chunk(cfg, chunk, state, tables)
    assert len(calls) == cfg.n_steps
    for a, b in zip(out_a, out_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _assert_carry_close(st_a, st_b, exact_floats=True)


def test_wrapper_checks():
    cfg = ttrk.default_config(constants.GPS_L1_CA, FS, 100)
    n = cfg.chunk_len + cfg.n_max
    st = ttrk.init_state(3, device="cpu")
    good = dict(chunk=torch.zeros((n, 2)), carry=tk.pack_carry(st),
                code_tables=torch.ones((3, 1023)), sec_tables=None)
    tk._check(cfg, **good)
    bad_cases = [
        (ValueError, dict(chunk=torch.zeros((n - 1, 2)))),
        (ValueError, dict(chunk=torch.zeros((n, 2), dtype=torch.float64))),
        (ValueError, dict(chunk=torch.zeros((2, n)).t())),
        (ValueError, dict(chunk=torch.zeros((n, 2), device="meta"))),
        (ValueError, dict(carry=good["carry"][:, :-1].contiguous())),
        (ValueError, dict(carry=good["carry"].float())),
        (ValueError, dict(code_tables=torch.ones((3, 50000)))),
        (ValueError, dict(code_tables=torch.ones((3, 1023),
                                                 dtype=torch.float64))),
        (ValueError, dict(sec_tables=torch.ones((2, 32)))),
        (TypeError, dict(code_tables=np.ones((3, 1023), np.float32))),
    ]
    for exc, change in bad_cases:
        with pytest.raises(exc):
            tk._check(cfg, **dict(good, **change))
    # the Kalman carrier loop is taken, and its parameter word selects the
    # kernel's KF variants (csrc/tracking.cu variant())
    kf = dataclasses.replace(cfg, carrier_kf=True)
    tk._check(kf, **good)
    assert (tk.make_params(kf, 3, n, 1023, 0).carrier_kf,
            tk.make_params(cfg, 3, n, 1023, 0).carrier_kf) == (1, 0)
    # pilot tracking takes [C, 2, Lt] tables (and one more tap's carry)
    with pytest.raises(ValueError):
        tk._check(dataclasses.replace(cfg, track_pilot=True), **good)
    nine = dataclasses.replace(cfg, tap_offsets=tuple(np.linspace(-1, 1, 9)))
    with pytest.raises(ValueError):
        tk._check(nine, **good)
    # the launch itself takes CUDA tensors only, and counts nothing else
    before = tk.launches
    with pytest.raises(ValueError):
        tk.track_chunk_fused(cfg, good["chunk"], st, good["code_tables"])
    assert tk.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("extended", [False, True])
def test_cuda_kernel_matches_eager_plain(extended):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda", 0)
    case = scenario.tracking_handoff_case(dev, extended=extended)
    cfg, state = case["cfg"], case["state"]
    chunk = torch.from_numpy(case["chunk"]).to(dev)
    tables = torch.from_numpy(case["tables"]).to(dev)
    sec = None if case["sec"] is None else torch.from_numpy(case["sec"]).to(dev)
    before = tk.launches
    new, packed = ttrk.track_chunk_packed(cfg, chunk, state, tables, sec)
    assert tk.launches == before + 1
    ref_state, out = ttrk.track_chunk(
        cfg, chunk, state, tables, sec,
        correlate=correlator.epoch_correlate_plain)
    ref = ttrk.pack_host_outputs(out, ref_state.loss_of_lock)
    torch.cuda.synchronize()
    _assert_packed_close(packed.cpu().numpy(), ref.cpu().numpy())
    _assert_carry_close(new, ref_state)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["gps", "e1_pilot", "e5a_pilot", "l2c"])
def test_cuda_kernel_bitwise_at_forced_cluster(case, m):
    """K2 with each channel on a forced cluster of m blocks gives the eager
    loop's (plain correlator) packed rows and carry bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda", 0)
    kw = {"gps": {}, "e1_pilot": dict(signal="1B", pilot=True),
          "e5a_pilot": dict(signal="5X", pilot=True),
          "l2c": dict(signal="2S", n_channels=5)}[case]
    c = scenario.tracking_handoff_case(dev, **kw)
    cfg, state = c["cfg"], c["state"]
    chunk = torch.from_numpy(c["chunk"]).to(dev)
    tables = torch.from_numpy(c["tables"]).to(dev)
    before = tk.launches
    carry, packed = tk.track_chunk_carry(cfg, chunk, tk.pack_carry(state),
                                         tables, cluster=m)
    assert tk.launches == before + 1
    ref_state, out = ttrk.track_chunk(
        cfg, chunk, state, tables, correlate=correlator.epoch_correlate_plain)
    ref = ttrk.pack_host_outputs(out, ref_state.loss_of_lock)
    torch.cuda.synchronize()
    assert torch.equal(packed.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(carry, tk.pack_carry(ref_state))


# GPS L2C (20 ms epochs, n_max 40,064) over one two-chunk dispatch, and
# BeiDou B1I at 4 MSps, plain and with the NH20 wipe after the extension
SIGNAL_CASES = {"l2c_two_chunks": dict(signal="2S", chunks=2),
                "b1i": dict(signal="B1"),
                "b1i_nh20": dict(signal="B1", extended=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_cuda_kernel_bitwise_at_l2c_and_b1i(case):
    """K2 gives the eager loop's (plain correlator) packed rows and carry
    bit for bit at the GPS L2C and BeiDou B1I shapes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda", 0)
    c = scenario.tracking_handoff_case(dev, **SIGNAL_CASES[case])
    cfg, state = c["cfg"], c["state"]
    chunk = torch.from_numpy(c["chunk"]).to(dev)
    tables = torch.from_numpy(c["tables"]).to(dev)
    sec = None if c["sec"] is None else torch.from_numpy(c["sec"]).to(dev)
    before = tk.launches
    new, packed = ttrk.track_chunk_packed(cfg, chunk, state, tables, sec)
    assert tk.launches == before + 1
    ref_state, out = ttrk.track_chunk(
        cfg, chunk, state, tables, sec,
        correlate=correlator.epoch_correlate_plain)
    ref = ttrk.pack_host_outputs(out, ref_state.loss_of_lock)
    torch.cuda.synchronize()
    assert torch.equal(packed.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(tk.pack_carry(new), tk.pack_carry(ref_state))


def test_host_edits_on_the_packed_carry():
    """start_channel, stop_channel (the receiver's _drop_channel) and
    set_extension on the packed carry give pack() of the same edits on the
    TrackingState, and unpack_carry inverts pack_carry after each."""
    st = ttrk.init_state(4, 3, device="cpu")
    buf = tk.pack_carry(st)
    edits = [
        lambda c: ttrk.start_channel(c, 1, code_freq=1.0231e6,
                                     doppler_hz=-1500.0, sample_offset=77,
                                     rem_code_phase=0.25),
        lambda c: ttrk.start_channel(c, 3, code_freq=1.0229e6,
                                     doppler_hz=3100.0, sample_offset=-5),
        lambda c: ttrk.set_extension(c, 1, 20, 13),
        lambda c: ttrk.stop_channel(c, 3),
    ]
    for edit in edits:
        st, buf = edit(st), edit(buf)
        assert isinstance(buf, torch.Tensor) and buf.dtype == torch.int32
        assert torch.equal(buf, tk.pack_carry(st))
        _assert_carry_close(tk.unpack_carry(buf), st, exact_floats=True)
    assert ttrk.state_to_numpy(buf).active.tolist() == [False, True, False,
                                                        False]


def test_cpu_dispatch_on_the_packed_carry(handoff):
    """track_chunk_packed returns the carry in the form it was given; the
    packed form is the eager loop's carry, packed."""
    cfg, state = handoff["cfg"], handoff["state"]
    chunk = torch.from_numpy(handoff["chunk"])
    tables = torch.from_numpy(handoff["tables"])
    sec = torch.from_numpy(handoff["sec"])
    new, packed = ttrk.track_chunk_packed(cfg, chunk, state, tables, sec)
    buf, packed_b = ttrk.track_chunk_packed(cfg, chunk, tk.pack_carry(state),
                                            tables, sec)
    assert torch.equal(buf, tk.pack_carry(new))
    assert torch.equal(packed_b.view(torch.int32), packed.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [1, 16])
def test_cuda_packed_dispatch_matches_unpacked(chunks):
    """On the card, the receiver's dispatch on the device-resident packed
    carry (one launch, no packing) gives the unpacked dispatch's packed
    outputs and final carry bit for bit, over a 102-step and a 1602-step
    dispatch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda", 0)
    case = scenario.tracking_handoff_case(dev, chunks=chunks)
    cfg, state = case["cfg"], case["state"]
    assert cfg.n_steps == (102 if chunks == 1 else 1602)
    chunk = torch.from_numpy(case["chunk"]).to(dev)
    tables = torch.from_numpy(case["tables"]).to(dev)
    new, packed = ttrk.track_chunk_packed(cfg, chunk, state, tables)
    before = tk.launches
    buf, packed_b = ttrk.track_chunk_packed(cfg, chunk, tk.pack_carry(state),
                                            tables)
    assert tk.launches == before + 1
    assert buf.device == dev and buf.dtype == torch.int32
    assert torch.equal(packed_b.view(torch.int32), packed.view(torch.int32))
    assert torch.equal(buf, tk.pack_carry(new))


def _bound_ratio(a, b) -> float:
    """max |a - b| / (1e-4 + 1e-4 |b|): at most 1 within the tolerance."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1e-4 + 1e-4 * np.abs(b))).max())


def _readings(seeds) -> None:
    """Print, per seed and handoff case, whether the int fields equal the
    JAX package's, and the packed float columns', the prompt's and the
    worst float carry field's distance in units of the tolerance."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    for seed in seeds:
        for extended in (False, True):
            case = scenario.tracking_handoff_case("cpu", seed=seed,
                                                  extended=extended)
            new, packed, jnew, jpacked = _both(case)
            f, i32, lol = ttrk.unpack_host_outputs(packed)
            jf, ji32, jlol = ttrk.unpack_host_outputs(jpacked)
            ints = (np.array_equal(i32, ji32) and np.array_equal(lol, jlol)
                    and np.array_equal(f[..., 8], jf[..., 8]))
            carry, worst = 0.0, ""
            for (name, a), (_, b) in zip(_fields(new), _fields(jnew)):
                if a.dtype.kind in "biu":
                    ints = ints and np.array_equal(a, b)
                elif _bound_ratio(a, b) > carry:
                    carry, worst = _bound_ratio(a, b), name
            z, jz = f[..., 0] + 1j * f[..., 1], jf[..., 0] + 1j * jf[..., 1]
            prompt = float((np.abs(z - jz) / (1e-4 + 1e-4 * np.abs(jz))).max())
            print(f"seed={seed} case={'extended' if extended else 'plain'} "
                  f"ints_equal={ints} "
                  f"float_columns={_bound_ratio(f[..., 2:8], jf[..., 2:8]):.4f} "
                  f"prompt={prompt:.4f} carry_floats={carry:.4f} "
                  f"carry_worst={worst}", flush=True)


def _profile(repeats: int = 3) -> None:
    """Profile the eager loop (K2's plain version) on one chunk of the L5
    handoff at 4 channels on the CPU, one thread: the host operations per
    step (every operator torch.profiler records, nested ones included), the
    ten most frequent, the chunk's seconds (the least of ``repeats`` runs),
    and its seconds with the correlator replaced by zeros (the rest of the
    loop)."""
    import collections
    import time

    c = scenario.tracking_handoff_case("cpu", signal="L5", n_channels=4)
    args = (c["cfg"], torch.from_numpy(c["chunk"]), c["state"],
            torch.from_numpy(c["tables"]))
    steps = c["cfg"].n_steps
    zeros = torch.zeros((4, c["cfg"].n_taps, 2))

    def least(**kw) -> float:
        ttrk.track_chunk(*args, **kw)                     # warm-up
        t = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            ttrk.track_chunk(*args, **kw)
            t = min(t, time.perf_counter() - t0)
        return t

    best = least()
    rest = least(correlate=lambda *a, **k: zeros)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ttrk.track_chunk(*args)
    counts = collections.Counter({e.key: e.count
                                  for e in prof.key_averages()})
    print(f"eager loop, L5 C=4, {steps} steps: chunk_s={best:.4f} "
          f"without_correlator_s={rest:.4f} "
          f"ops_per_step={sum(counts.values()) / steps:.1f}")
    for name, n in counts.most_common(10):
        print(f"  {name}: {n / steps:.1f} per step")


def _profile_against(baseline: str, repeats: int = 5) -> None:
    """The eager loop of one chunk with this checkout's plain correlator,
    with ``baseline``'s (another checkout's ops/correlator.py, loaded
    beside this one) and with zeros, in turns, one thread."""
    import importlib.util
    import time

    spec = importlib.util.spec_from_file_location(
        "baseline_correlator", pathlib.Path(baseline) / "gnss_sdr_tpu_torch"
        / "ops" / "correlator.py")
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    for kw in (dict(signal="L5", n_channels=4),
               dict(signal="1C", n_channels=8),
               dict(signal="1B", pilot=True),
               dict(signal="2S", n_channels=5)):
        c = scenario.tracking_handoff_case("cpu", **kw)
        args = (c["cfg"], torch.from_numpy(c["chunk"]), c["state"],
                torch.from_numpy(c["tables"]))
        zeros = torch.zeros((c["tables"].shape[0], c["cfg"].n_taps, 2))
        fns = {"baseline": base.epoch_correlate_plain,
               "this": correlator.epoch_correlate_plain,
               "zeros": lambda *a, **k: zeros}
        best = dict.fromkeys(fns, float("inf"))
        for name, fn in fns.items():
            ttrk.track_chunk(*args, correlate=fn)          # warm-up
        for rep in range(repeats):
            for name in (fns if rep % 2 == 0 else reversed(list(fns))):
                t0 = time.perf_counter()
                ttrk.track_chunk(*args, correlate=fns[name])
                best[name] = min(best[name], time.perf_counter() - t0)
        share = {k: (best[k] - best["zeros"]) / best[k]
                 for k in ("baseline", "this")}
        print(f"{kw}: chunk_s baseline={best['baseline']:.4f} "
              f"this={best['this']:.4f} zeros={best['zeros']:.4f} "
              f"correlator_share baseline={share['baseline']:.3f} "
              f"this={share['this']:.3f}")


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--profile"]:
        _profile()
    elif sys.argv[1:2] == ["--profile-against"]:
        _profile_against(sys.argv[2])
    else:
        _readings([int(a) for a in sys.argv[1:]]
                  or [1, 2, 3, 4, 5, 6, 7, 8, 11])
