"""GPS L2C (L2 CM, ``signal="2S"``) in the port against the JAX package, on
the CPU:

- ``gps_l2cm_code`` for every PRN of the ICD table (1-115): bit for bit;
- tracking: the ``"2S"`` handoff case (five satellites at 2 MSps, one
  20 ms code epoch of 40,000 samples per step, n_max 40,064, 7 steps per
  100 ms chunk; and a two-chunk dispatch of 12 steps) through JAX
  ``track_chunk`` and the port's eager loop (K2's plain version) from the
  identical carry. The rules of tests/test_torch_tracking.py: int fields
  exact at every step; correlator sums (every tap, the prompt, and the
  carry's ``prev_prompt`` and ``acc_corr``) as complex values, |dz| <=
  1e-4 |z| + 1e-4; every other float field and carry field within rtol /
  atol 1e-4. Fed JAX's own sums, the loop keeps JAX's bits;
- PCPS with the doubled 80,000-sample window (the receiver's ``acq_double``
  rule: one CNAV symbol per code epoch) against JAX ``pcps_search`` on a
  narrow Doppler grid in both packages: the same cell (code phase, Doppler
  bin), every statistic within 1e-4 relative (the wideband tests' bound);
- ``GpsL2CMTelemetry`` on tests/test_telemetry_channels.py's CNAV stream
  (seed 3, start 213, inverted polarity), the port's decoder in one push
  and in 137-epoch blocks (its frame search resuming across pushes): the
  same frame anchor, TOW reference, transmit times and ephemeris as JAX's
  decoder;
- the shipped ``conf/gps_l2c.conf`` binds as JAX binds it, passes
  ``check_ported`` and builds a receiver.

The whole L2C chain (58 s of five satellites) is held on the card by
chip_smoke.py's ``l2c`` phase: the JAX L2C e2e alone takes 11-20 minutes of
one CPU worker.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.models import codes as jcodes
from gnss_sdr_tpu.models.nav import gps_cnav as jcnav
from gnss_sdr_tpu.ops import acquisition as jacq
from gnss_sdr_tpu.ops import iq as jiq
from gnss_sdr_tpu.receiver import telemetry as jtlm
from gnss_sdr_tpu.receiver import tracking as jtrk
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.config import registry as treg
from gnss_sdr_tpu_torch.models import codes as tcodes
from gnss_sdr_tpu_torch.ops import acquisition as tacq
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import receiver as trx
from gnss_sdr_tpu_torch.receiver import telemetry as ttlm
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.utils import scenario

from test_lnav import sample_ephemeris
from test_torch_motion import _same_sats
from test_torch_galileo_tracking import (FLOAT_FIELDS, INT_FIELDS,
                                         _complex_close, _jax_cfg,
                                         _jax_state,
                                         assert_fed_jax_sums_keep_bits,
                                         run_fed_jax_sums)

torch.set_num_threads(1)   # one thread per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMPLEX_CARRY = ("acc_corr", "prev_prompt")


def test_l2cm_codes_equal_jax():
    for prn in range(1, 116):
        np.testing.assert_array_equal(tcodes.code_chips("2S", prn),
                                      jcodes.gps_l2cm_code(prn),
                                      err_msg=str(prn))
    assert tcodes.gps_l2cm_code(1).shape == (10230,)


def test_scenario_equal_jax():
    """The five L2 CM satellites of tests/test_e2e_l2c.py: the same
    PRNs and satellite parameters as JAX's scenario (float64 round-off),
    and 0.1 s of its IQ within atol 1e-6."""
    from gnss_sdr_tpu.utils import scenario as jscen

    kw = dict(duration_s=58.0, n_sats=5, cn0_dbhz=45.0, fs=2.0e6)
    j = jscen.build_gps_l2c_scenario(**kw)
    t = scenario.build_gps_l2c_scenario(**kw)
    _same_sats(j, t)
    assert t.spec.signal == j.spec.signal and t.tow_bits_start == \
        j.tow_bits_start
    j.duration_s = t.duration_s = 0.1
    np.testing.assert_allclose(t.generate(seed=5), j.generate(seed=5),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------- tracking
@pytest.fixture(scope="module", params=[1, 2], ids=["chunk", "two_chunks"])
def open_loop(request):
    c = scenario.tracking_handoff_case("cpu", signal="2S",
                                       chunks=request.param)
    cfg = c["cfg"]
    jst, jout = jtrk.track_chunk(_jax_cfg(cfg), jnp.asarray(c["chunk"]),
                                 _jax_state(c["state"]),
                                 jnp.asarray(c["tables"]), None)
    tst, tout = ttrk.track_chunk(cfg, torch.from_numpy(c["chunk"]),
                                 c["state"], torch.from_numpy(c["tables"]),
                                 None)
    return dict(cfg=cfg, jst=jst, jout=jout, tst=tst, tout=tout, case=c,
                chunks=request.param)


def test_open_loop_matches_jax(open_loop):
    cfg, jout, tout = open_loop["cfg"], open_loop["jout"], open_loop["tout"]
    steps = {1: 7, 2: 12}[open_loop["chunks"]]
    assert (cfg.n_steps, cfg.n_max, cfg.table_rate, cfg.n_taps) == \
        (steps, 40064, 1, 3)
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), f"{f}: first (step, channel) differing {bad[:5]}"
    assert np.asarray(jout.valid)[:, :5].sum() == 5 * (steps - 2)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("prompt", "correlators"):
        _complex_close(np.asarray(getattr(jout, f)),
                       getattr(tout, f).numpy())
    jst, tst = open_loop["jst"], ttrk.state_to_numpy(open_loop["tst"])
    for name in COMPLEX_CARRY:
        _complex_close(np.asarray(getattr(jst, name)), getattr(tst, name))
    for name in ttrk.TrackingState._fields:
        if name in COMPLEX_CARRY:
            continue
        a, b = getattr(jst, name), getattr(tst, name)
        for field, x, y in (zip(a._fields, a, b)
                            if name in ("dll", "pll", "cn0")
                            else [(name, a, b)]):
            x = np.asarray(x)
            if x.dtype.kind in "biu":
                np.testing.assert_array_equal(y, x, err_msg=name)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name}.{field}")


def test_fed_jax_sums_keep_jax_bits(open_loop):
    tst, tout = run_fed_jax_sums(open_loop)
    assert_fed_jax_sums_keep_bits(open_loop["jst"], open_loop["jout"], tst,
                                  tout)


def test_k2_wrapper_at_the_l2c_shape():
    """Ten 4096-sample tiles per 40,064-sample window, the 10,230-entry
    table and the ring within the block's shared memory, the parameter
    block at this shape; on a 132-SM card the cluster takes 8 blocks a
    channel at the receivers' channel counts and 1 where C m > 132."""
    c = scenario.tracking_handoff_case("cpu", signal="2S")
    cfg = c["cfg"]
    tk._check(cfg, chunk=torch.from_numpy(c["chunk"]),
              carry=tk.pack_carry(c["state"]),
              code_tables=torch.from_numpy(c["tables"]), sec_tables=None)
    p = tk.make_params(cfg, 6, len(c["chunk"]), 10230, 32)
    assert (p.n_steps, p.n_max, p.chunk_len, p.table_len) == \
        (7, 40064, 200000, 10230)
    assert p.tile == tk.TILE_MAX and -(-40064 // p.tile) == 10
    assert tk.shared_bytes(40064, 10230, 1) < tk.MAX_SMEM_BYTES
    assert tk.pick_cluster(5, 40064, lambda m: 132 // m, 132) == 8
    assert tk.pick_cluster(128, 40064, lambda m: 132 // m, 132) == 1


# ------------------------------------------------------------- acquisition
def test_pcps_doubled_window_equal_jax():
    """L2 CM PRN 13 at 46 dB-Hz with a CNAV symbol flip at every code
    boundary, 2 MSps, seed 4: the receiver's doubled window (one code
    period of replica zero-padded to 80,000 samples, two dwells) on a
    nine-bin grid of 25 Hz around the truth, at three dwell starts."""
    from gnss_sdr_tpu import constants as jconst
    from gnss_sdr_tpu.utils import generator as jgen

    fs, spc, prn, fd_true = 2.0e6, 40000, 13, 1310.0
    bits = np.sign(np.random.default_rng(2).standard_normal(40))
    x = jgen.generate(
        jconst.GPS_L2_CM, [jgen.SatParams(prn=prn, cn0_dbhz=46.0,
                                          doppler_hz=fd_true,
                                          code_delay_s=7.3e-3,
                                          data_bits=bits)],
        fs, 0.3, seed=4)
    rep = jcodes.sample_code(jcodes.gps_l2cm_code(prn).astype(np.float64),
                             fs, 0.5115e6, spc)
    cf2 = jiq.split(np.conj(np.fft.fft(np.concatenate(
        [rep, np.zeros_like(rep)]))))[None]
    dop = jacq.make_doppler_grid(100.0, 25.0, doppler_center=1300.0)
    np.testing.assert_array_equal(
        dop, tacq.make_doppler_grid(100.0, 25.0, doppler_center=1300.0))
    for start in (0, 40000, 97000):
        seg = jiq.split(np.ascontiguousarray(x[start: start + 4 * spc]))
        kw = dict(fs=fs, samples_per_code=spc, samples_per_chip=4,
                  noncoherent=2)
        j = jacq.pcps_search(seg, cf2, dop, **kw)
        t = tacq.pcps_search(torch.from_numpy(seg), torch.from_numpy(cf2),
                             torch.from_numpy(dop), **kw)
        np.testing.assert_array_equal(t.code_phase.numpy(),
                                      np.asarray(j.code_phase))
        np.testing.assert_array_equal(t.doppler_hz.numpy(),
                                      np.asarray(j.doppler_hz))
        for f in ("test_max_power", "test_cfar", "magnitude"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)), rtol=1e-4,
                                       err_msg=f)
        assert abs(float(t.doppler_hz[0]) - fd_true) <= 25.0


def test_receiver_acquisition_window_is_doubled():
    rx = trx.Receiver(trx.ReceiverConfig(signal="2S", fs=2.0e6, n_channels=5,
                                         prns=(1, 2)), device="cpu")
    g, = rx.groups
    assert g.acq_double and g.spc == 40000
    assert rx._acq_window(g) == (80000, 80000)
    assert (g.trk_cfg.n_max, g.trk_cfg.n_steps) == (40064, 7)


# --------------------------------------------------------------- telemetry
def _l2c_stream():
    """tests/test_telemetry_channels.py::test_l2c_cnav_telemetry's prompts
    (seed 3, start 213, polarity inverted)."""
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    sym = jcnav.encode_symbol_stream(eph, 352800.0, 6)
    prompts = -120.0 * (2.0 * sym.astype(np.float64) - 1.0)
    prompts += np.random.default_rng(3).normal(0, 20.0, len(prompts))
    return -prompts[213:]


def _feed(tlm, prompts, chunk, epoch0=0):
    e = epoch0 + np.arange(len(prompts), dtype=np.int64)
    for i in range(0, len(prompts), chunk):
        tlm.push(e[i:i + chunk], prompts[i:i + chunk])


@pytest.fixture(scope="module")
def jax_l2c_decoder():
    """JAX's decoder on the stream in one push (its frame search starts
    again at offset 0 on every push, so its 137-epoch feed finds the same
    anchor at the cost of one search per block)."""
    j = jtlm.make_telemetry("2S", 7)
    prompts = _l2c_stream()
    _feed(j, prompts, len(prompts), epoch0=41)
    return j


@pytest.mark.parametrize("chunk", [137, None], ids=["blocks", "one_push"])
def test_l2c_telemetry_equal_jax(chunk, jax_l2c_decoder):
    prompts = _l2c_stream()
    t, j = ttlm.make_telemetry("2S", 7), jax_l2c_decoder
    assert isinstance(t, ttlm.GpsL2CMTelemetry)
    _feed(t, prompts, chunk or len(prompts), epoch0=41)
    assert t.message_count == j.message_count >= 3
    assert t._frame_anchor == j._frame_anchor
    assert t.half_cycle == j.half_cycle
    assert dataclasses.asdict(t.tow_ref) == dataclasses.asdict(j.tow_ref)
    for ep in (41, 500, 2000):
        for chips in (0.0, 5115.5, 10229.9):
            assert t.transmit_time(ep, chips) == j.transmit_time(ep, chips)
    assert dataclasses.asdict(t.ephemeris()) == \
        dataclasses.asdict(j.ephemeris())


# ------------------------------------------------------------------ config
def test_l2c_conf_binds_and_builds():
    conf = ROOT / "conf" / "gps_l2c.conf"
    want = jini.receiver_config_from_ini(jini.FileConfiguration(conf))
    tconf = tini.FileConfiguration(conf)
    got = tini.receiver_config_from_ini(tconf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.signal, got.n_channels, got.fs) == ("2S", 6, 2.0e6)
    treg.check_ported(tconf, got.signal_plan)
    g, = trx.Receiver(got, device="cpu").groups
    assert g.code_tables.shape == (6, 10230)
