"""Port tracking loop (gnss_sdr_tpu_torch.receiver.tracking) against the JAX
package: one 102-step chunk of generated GPS L1 C/A signal from the identical
carry (JAX ``init_state`` + ``start_channel``, moved across with
``state_from_numpy``), on plain [C, 1023] chip tables, which make JAX take
its gather path (tracking.py:445-447); a second case switches two channels
to 20-epoch coherent integration and one to a secondary-code wipe, the loop
paths that GPS L1 C/A alone never takes. Integer fields must be equal; float
fields agree within rtol 1e-4, atol 1e-4. The correlator sums (prompt and
all taps) are complex numbers summed over ~2000 samples in a different order
by the two packages, so for them the same rtol/atol bound the complex error
|dz| against |z|, not each of I and Q alone (a component near zero carries
the whole sum's rounding, ~1e-3 here).

The chunk is generated from seeds 11, 12 and 13. Seed 11's cases keep the
bare ids ``plain`` / ``extended`` and every comparison above. Seed 13 keeps
them too, but for one carry field (the second point below): its one
departure used to be a carrier frequency an ulp off at step 35, where the
two libraries' float32 atan in the Costas discriminator differed (on ~4 %
of random inputs); the port now computes the C library's ``atanf`` that
XLA's CPU backend calls, written out (``ops/discriminators.py``
``atan32``), and keeps JAX's bits there. Seed 12 holds the same fields
with two departures derived from the sums' rounding:

* The sums are compared in JAX's carrier phase. Fed JAX's own sums
  (``correlate=``, ``test_fed_jax_sums_keep_jax_bits``), the port's loop
  keeps JAX's carrier frequency and phase bits on seeds 11 and 12, and on
  seed 13 up to step 61 of channel 4 (``FED_FLL_FLIP``): there the FLL's
  complex product P_k conj(P_{k-1}) rounds as PyTorch's complex multiply,
  where XLA fuses each part into one FMA (a c + b d, b c - a d). Written
  as XLA's, it keeps seed 13's bits there too, but turns seed 11's
  trajectory on its own sums so that a ``prev_prompt`` component near zero
  misses rtol 1e-4 (3.4x): so the product stays PyTorch's, and seed 11
  keeps its checks. Fed its own sums, the port's FLL turns out
  1-2 float32 ulps off JAX's carrier frequency during pull-in (seed 12
  ``plain``, channel 1, from step 7): the sums' block order, which leaves
  no order of operations to write out. That integrates to a carrier phase
  2.03e-5 cycles off by step 100 and turns the prompt by 1.3e-4 rad, past
  the sums' own bound (1.27 of it unrotated). So on seed 12 the phase
  difference the fields report is first held within ``DPHI_MAX`` = 2^-12
  Hz x 102 ms = 2.49e-5 cycles (one ulp of a carrier frequency below 4096
  Hz, held over the whole chunk), and the port's sums (the prompt, every
  tap, the carry's ``prev_prompt`` and ``acc_corr``) are then turned by it
  before the complex comparison. Against seed 11's check this lets through
  up to 2 pi ``DPHI_MAX`` = 1.6e-4 rad of common rotation.
* ``cn0.ema_i2_minus_q2``, the EMA of I^2 - Q^2 of the prompt, has a bound
  of its own on seeds 12 and 13. Fed JAX's sums, the port's moments keep
  JAX's bits (``ops/cn0.py`` writes out the FMAs XLA contracts); the
  difference left is the prompt's. With |dP| <= e |P| + EPS for every
  prompt that entered the EMA (e = EPS + 2 pi max |dphi|: the sums' bound
  plus the rotation, 0 on seed 13),
  |d(I^2 - Q^2)| <= 2 |P| |dP| + |dP|^2, and the EMA is a convex
  combination of those terms with the weights of ``cn0.ema_i2_plus_q2`` =
  EMA of |P|^2 = s^2, so by Cauchy-Schwarz |d ema_i2_minus_q2| <= d (2 s
  + d) with d = e s + EPS (``moment_bounds``; the same steps with
  |d|I|| <= |dP| give |d ema_abs_i| <= d, which
  tests/test_torch_wideband_tracking.py uses). Held relative to itself,
  the field fails where the lock metric is near 0 (I^2 ~ Q^2 cancels:
  15-18x the 1e-4 bound on seeds 12 / 13, 7.4x on seed 13 with the atan
  written out)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gnss_sdr_tpu import constants as jconst
from gnss_sdr_tpu.receiver import tracking as jtrk
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.models import codes
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.utils import generator

from test_torch_galileo_tracking import (FED_OTHER_ROUNDING,
                                         assert_fed_jax_sums_keep_bits,
                                         jax_correlate, moment_bounds)

torch.set_num_threads(1)   # one thread per xdist worker

FS = 2.0e6
INT_FIELDS = ("valid", "state", "n_samples", "start_offset", "epoch_index",
              "carr_phase_cycles")
FLOAT_FIELDS = ("rem_code_phase", "code_freq", "carrier_freq",
                "carr_phase_frac", "cn0_dbhz", "carrier_lock")
IQ_FIELDS = ("prompt", "correlators")


CASES = [(mode, seed) for seed in (11, 12, 13)
         for mode in ("plain", "extended")]
EPS = 1e-4   # the correlator sums' relative bound (module docstring)
DPHI_MAX = 2.0 ** -12 * 0.102   # cycles: 1 ulp below 4096 Hz over 102 ms
ROTATED_SEEDS = (12,)   # sums compared in JAX's carrier phase (docstring)
# fed JAX's sums: (step, channel) from which one channel's floats leave
# JAX's bits, by seed (module docstring)
FED_FLL_FLIP = {13: (62, 4)}


@pytest.fixture(scope="module", params=CASES,
                ids=[m if s == 11 else f"{m}-seed{s}" for m, s in CASES])
def open_loop(request):
    mode, seed = request.param
    spec = constants.GPS_L1_CA
    # 5 satellites on 6 channels (one idle); handoffs slightly off the truth
    sats = [generator.SatParams(prn=p, cn0_dbhz=45.0 + i, doppler_hz=d,
                                code_delay_s=cd)
            for i, (p, d, cd) in enumerate([(3, 1200.0, 1.1e-4),
                                            (7, -2400.0, 3.3e-4),
                                            (11, 350.0, 6.1e-4),
                                            (19, 3900.0, 8.4e-4),
                                            (24, -800.0, 2.0e-4)])]
    jcfg = jtrk.default_config(jconst.GPS_L1_CA, FS, 100, stride_plan=None)
    tcfg = ttrk.TrackingConfig.from_fields(dataclasses.asdict(jcfg))
    assert tcfg == ttrk.default_config(spec, FS, 100)
    assert jcfg.n_steps == 102
    n = jcfg.chunk_len + jcfg.n_max
    x = generator.generate(spec, sats, FS, n / FS, seed=seed)
    chunk = np.stack([x.real, x.imag], -1).astype(np.float32)

    n_ch = 6
    state = jtrk.init_state(n_ch, 3)
    tables = np.zeros((n_ch, 1023), np.float32)
    spc = FS / 1.023e6
    for ch, sp in enumerate(sats):
        # next code boundary after sample 0: delay d puts chip 0 at d*fs
        start = sp.code_delay_s * FS
        off = int(np.ceil(start))
        state = jtrk.start_channel(
            state, ch, code_freq=1.023e6 * (1 + (sp.doppler_hz + 15.0)
                                           / spec.carrier_freq_hz),
            doppler_hz=sp.doppler_hz + 15.0 * (ch - 2), sample_offset=off,
            rem_code_phase=float((off - start) / spc))
        tables[ch] = codes.code_chips("1C", sp.prn)

    sec = None
    if mode == "extended":
        sec = np.ones((n_ch, jcfg.sec_table_len), np.float32)
        state = jtrk.set_extension(state, 1, 20, 7)
        state = jtrk.set_extension(state, 3, 20, 0)
        state = jtrk.set_secondary(state, sec, 3,
                                   [0, 0, 1, 0, 1, 1, 0, 1, 0, 0], 2)
    jst, jout = jtrk.track_chunk(
        jcfg, jnp.asarray(chunk), state, jnp.asarray(tables),
        None if sec is None else jnp.asarray(sec))
    tstate = ttrk.state_from_numpy(state, "cpu")
    tst, tout = ttrk.track_chunk(
        tcfg, torch.from_numpy(chunk), tstate, torch.from_numpy(tables),
        None if sec is None else torch.from_numpy(sec))
    return dict(jst=jst, jout=jout, tst=tst, tout=tout, jcfg=jcfg,
                seed=seed, tcfg=tcfg, chunk=chunk, tables=tables, sec=sec,
                state=tstate)


def _phase_diff(jcycles, jfrac, tcycles, tfrac):
    """The port's carrier phase minus JAX's, in cycles (float64)."""
    as64 = lambda v: np.asarray(v, np.float64)
    return (as64(tcycles) - as64(jcycles)) + (as64(tfrac) - as64(jfrac))


def _rotations(open_loop):
    """(per-step, final-carry) phase differences by which the port's sums
    are turned: 0 on seeds 11 and 13; on seed 12 the reported difference,
    held within DPHI_MAX first (module docstring)."""
    jout, tout, jst = open_loop["jout"], open_loop["tout"], open_loop["jst"]
    tst = ttrk.state_to_numpy(open_loop["tst"])
    steps = _phase_diff(jout.carr_phase_cycles, jout.carr_phase_frac,
                        tout.carr_phase_cycles, tout.carr_phase_frac)
    carry = _phase_diff(jst.carr_phase_cycles, jst.carr_phase_frac,
                        tst.carr_phase_cycles, tst.carr_phase_frac)
    if open_loop["seed"] not in ROTATED_SEEDS:
        return np.zeros_like(steps), np.zeros_like(carry)
    worst = max(np.abs(steps).max(), np.abs(carry).max())
    assert worst <= DPHI_MAX, (worst, DPHI_MAX)
    return steps, carry


def _assert_sums_close(a, b, dphi, what):
    """Correlator sums [..., 2]: the port's, turned into JAX's carrier phase
    by ``dphi`` cycles (0 but on seed 12), within |dz| <= EPS |z| + EPS of
    JAX's."""
    za = a[..., 0] + 1j * a[..., 1]
    zb = (b[..., 0] + 1j * b[..., 1]) * np.exp(2j * np.pi * dphi)
    bad = np.abs(zb - za) > EPS * np.abs(za) + EPS
    assert not bad.any(), f"{what}: {np.argwhere(bad)[:5]}"


def test_open_loop_int_fields_equal(open_loop):
    for f in INT_FIELDS:
        a = np.asarray(getattr(open_loop["jout"], f))
        b = getattr(open_loop["tout"], f).numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), f"{f}: first (step, channel) differing {bad[:5]}"
    assert np.asarray(open_loop["jout"].valid)[:, :5].sum() > 400


def test_open_loop_float_fields_close(open_loop):
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(
            getattr(open_loop["tout"], f).numpy(),
            np.asarray(getattr(open_loop["jout"], f)),
            rtol=1e-4, atol=1e-4, err_msg=f)
    dphi, _ = _rotations(open_loop)
    for f in IQ_FIELDS:
        a = np.asarray(getattr(open_loop["jout"], f))
        b = getattr(open_loop["tout"], f).numpy()
        _assert_sums_close(a, b, dphi if a.ndim == 3 else dphi[..., None], f)


def test_open_loop_final_carry(open_loop):
    jst = open_loop["jst"]
    tst = ttrk.state_to_numpy(open_loop["tst"])
    new_seed = open_loop["seed"] != 11
    rotated = open_loop["seed"] in ROTATED_SEEDS
    dphi, dphi_carry = _rotations(open_loop)
    e = EPS + 2 * np.pi * max(np.abs(dphi).max(), np.abs(dphi_carry).max())
    for name in ttrk.TrackingState._fields:
        a, b = getattr(jst, name), getattr(tst, name)
        pairs = (zip(a._fields, a, b) if name in ("dll", "pll", "cn0")
                 else [(name, a, b)])
        for field, x, y in pairs:
            x = np.asarray(x)
            if x.dtype.kind in "biu":
                np.testing.assert_array_equal(y, x, err_msg=name)
            elif rotated and name in ("prev_prompt", "acc_corr"):
                _assert_sums_close(x, y, dphi_carry.reshape(
                    dphi_carry.shape + (1,) * (x.ndim - 2)), name)
            elif new_seed and field == "ema_i2_minus_q2":
                bound = moment_bounds(jst.cn0.ema_i2_plus_q2, e)[field]
                err = np.abs(y - x)
                assert (err <= bound).all(), (field, err / bound)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4,
                                           err_msg=name)


def test_fed_jax_sums_keep_jax_bits(open_loop):
    """Fed JAX's own sums, the port's loop keeps JAX's bits in every field
    but FED_OTHER_ROUNDING on seeds 11 and 12; on seed 13 too, but for one
    channel's floats from the step FED_FLL_FLIP names on (module
    docstring), whose int fields still hold JAX's bits."""
    sec = open_loop["sec"]
    tst, tout = ttrk.track_chunk(
        open_loop["tcfg"], torch.from_numpy(open_loop["chunk"]),
        open_loop["state"], torch.from_numpy(open_loop["tables"]),
        None if sec is None else torch.from_numpy(sec),
        correlate=jax_correlate)
    jst, jout = open_loop["jst"], open_loop["jout"]
    flip = FED_FLL_FLIP.get(open_loop["seed"])
    if flip is None:
        assert_fed_jax_sums_keep_bits(jst, jout, tst, tout)
        return
    step, ch = flip
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)), f)
    keep = np.ones(tout.valid.shape, bool)
    keep[step:, ch] = False
    for f in FLOAT_FIELDS + IQ_FIELDS:
        if f in FED_OTHER_ROUNDING:
            continue
        a = np.asarray(getattr(jout, f)).view(np.int32)
        b = getattr(tout, f).numpy().view(np.int32)
        assert np.array_equal(a[keep], b[keep]), f
    cf = tout.carrier_freq.numpy()[step, ch]
    assert cf != np.asarray(jout.carrier_freq)[step, ch]


def test_pack_unpack_roundtrip(open_loop):
    tout, tst = open_loop["tout"], open_loop["tst"]
    packed = ttrk.pack_host_outputs(tout, tst.loss_of_lock).numpy()
    f32p, i32p, lol = ttrk.unpack_host_outputs(packed)
    np.testing.assert_array_equal(i32p[..., 0], tout.epoch_index.numpy())
    np.testing.assert_array_equal(i32p[..., 1], tout.start_offset.numpy())
    np.testing.assert_array_equal(i32p[..., 2],
                                  tout.carr_phase_cycles.numpy())
    np.testing.assert_array_equal(lol, tst.loss_of_lock.numpy())
    np.testing.assert_array_equal(f32p[..., 8] > 0.5, tout.valid.numpy())
    # same layout as the JAX pack, int fields compared exactly
    jpacked = np.asarray(jtrk.pack_host_outputs(
        open_loop["jout"], jnp.asarray(open_loop["jst"].loss_of_lock)))
    _, ji32p, jlol = jtrk.unpack_host_outputs(jpacked)
    np.testing.assert_array_equal(i32p, ji32p)
    np.testing.assert_array_equal(lol, jlol)


def test_state_roundtrip_and_host_edits():
    st = ttrk.init_state(4, 3, device="cpu")
    js = jtrk.init_state(4, 3)
    st = ttrk.start_channel(st, 2, code_freq=1.0231e6, doppler_hz=-1500.0,
                            sample_offset=77, rem_code_phase=0.25)
    js = jtrk.start_channel(js, 2, code_freq=1.0231e6, doppler_hz=-1500.0,
                            sample_offset=77, rem_code_phase=0.25)
    st = ttrk.set_extension(st, 2, 20, 13)
    js = jtrk.set_extension(js, 2, 20, 13)
    sec_t, sec_j = np.ones((4, 32), np.float32), np.ones((4, 32), np.float32)
    st = ttrk.set_secondary(st, sec_t, 1, [0, 1, 1, 0], 5)
    js = jtrk.set_secondary(js, sec_j, 1, [0, 1, 1, 0], 5)
    st = ttrk.stop_channel(st, 1)
    js = jtrk.stop_channel(js, 1)
    np.testing.assert_array_equal(sec_t, sec_j)
    back = ttrk.state_to_numpy(
        ttrk.state_from_numpy(ttrk.state_to_numpy(st), "cpu"))
    for name in ttrk.TrackingState._fields:
        a, b = getattr(js, name), getattr(back, name)
        for x, y in (zip(a, b) if name in ("dll", "pll", "cn0") else [(a, b)]):
            assert np.asarray(x).dtype == y.dtype, name
            np.testing.assert_array_equal(y, np.asarray(x), err_msg=name)


def test_carry_has_no_default_device():
    """The carry's device is always named: no silent CPU default (the
    Receiver resolves its own device, cuda:0 or an error)."""
    with pytest.raises(TypeError):
        ttrk.init_state(4, 3)
    host = ttrk.state_to_numpy(ttrk.init_state(4, 3, device="cpu"))
    with pytest.raises(TypeError):
        ttrk.state_from_numpy(host)
    assert ttrk.state_from_numpy(host, "cpu").active.device.type == "cpu"


def test_unported_options_raise():
    with pytest.raises(ValueError):
        ttrk.TrackingConfig(fs=FS, code_length_chips=1023,
                            code_rate_cps=1.023e6, carrier_freq_hz=1.57542e9,
                            stride_plan=(1023, 2000, 2046000, 2064))
    # the Kalman carrier loop is ported: a KF config runs (tests/
    # test_torch_kalman_ramp.py holds it against JAX)
    cfg = dataclasses.replace(ttrk.default_config(constants.GPS_L1_CA, FS, 1),
                              carrier_kf=True)
    st, out = ttrk.track_chunk(
        cfg, torch.zeros((cfg.chunk_len + cfg.n_max, 2)),
        ttrk.init_state(1, device="cpu"), torch.ones((1, 1023)))
    assert out.valid.shape == (cfg.n_steps, 1) and st.kf_p.shape == (1, 3, 3)
