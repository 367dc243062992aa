"""BeiDou B1I (``signal="B1"``, MEO / IGSO satellites, D1 at 50 bps under
the NH20 overlay) in the port against the JAX package, on the CPU:

- ``beidou_b1i_code`` for PRNs 1-37: bit for bit;
- the D1 codec (models/nav/beidou_d1.py): BCH(15,11) codewords, subframes
  1-3 encoded and decoded, the assembled ephemeris and iono, and a
  corrupted subframe refused, all equal to JAX's;
- tracking: the ``"B1"`` handoff case (five satellites at 4 MSps, n_max
  4,064, 102 steps) through JAX ``track_chunk`` and the port's eager loop
  (K2's plain version) from the identical carry, plain and with the NH20
  wipe over one secondary period installed through ``set_secondary`` /
  ``set_extension`` as the receiver installs it after bit sync. The rules
  of tests/test_torch_tracking.py: int fields exact at every step;
  correlator sums (every tap, the prompt, and the carry's ``prev_prompt``
  and ``acc_corr``) as complex values, |dz| <= 1e-4 |z| + 1e-4; every other
  float field and carry field within rtol / atol 1e-4. Fed JAX's own sums,
  the loop keeps JAX's bits;
- ``BeidouB1ITelemetry`` on tests/test_telemetry_channels.py's D1 stream
  (seed 7, start 431, inverted polarity, epoch 55 first) in one push and in
  137-epoch blocks: the same NH phase, TOW reference, transmit times and
  ephemeris as JAX's decoder;
- RINEX: a D1 ephemeris as a BeiDou navigation record and a ``2I``
  observation header, byte for byte with JAX's writers (creation clock
  frozen), and the record read back as JAX reads it;
- the shipped ``conf/beidou_b1i.conf`` binds as JAX binds it
  and builds a receiver whose pool holds the GEO PRNs;
  GEO PRNs get the D2 decoder, ``signal="B3"`` builds, and SBAS PRNs (the
  one telemetry still to port) raise ``NotImplementedError``.

The whole B1I chain (30 s of four satellites) is held on the card by
chip_smoke.py's ``b1i`` phase.
"""

import dataclasses
import datetime
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.models import codes as jcodes
from gnss_sdr_tpu.models.ephemeris import IonoParams as JIono
from gnss_sdr_tpu.models.nav import beidou_d1 as jd1
from gnss_sdr_tpu.receiver import telemetry as jtlm
from gnss_sdr_tpu.receiver import tracking as jtrk
from gnss_sdr_tpu.receiver.pvt import rinex as jrinex
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.models import codes as tcodes
from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import beidou_d1 as td1
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import receiver as trx
from gnss_sdr_tpu_torch.receiver import telemetry as ttlm
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.receiver.pvt import rinex as trinex
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


def _port(eph) -> KeplerEphemeris:
    return KeplerEphemeris(**dataclasses.asdict(eph))


def test_b1i_codes_equal_jax():
    for prn in range(1, 38):
        np.testing.assert_array_equal(tcodes.code_chips("B1", prn),
                                      jcodes.beidou_b1i_code(prn),
                                      err_msg=str(prn))


# ------------------------------------------------------------------- D1
def test_d1_codec_equal_jax():
    """tests/test_nav_messages.py's BCH and subframe round trips through
    both packages' codecs."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        info = rng.integers(0, 2, 11).astype(np.uint8)
        cw = td1._bch15_encode(info)
        np.testing.assert_array_equal(cw, jd1._bch15_encode(info))
        assert td1._bch15_check(cw)
        bad = cw.copy()
        bad[int(rng.integers(0, 15))] ^= 1
        assert not td1._bch15_check(bad) and not jd1._bch15_check(bad)
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    alpha, beta = (1.2e-8, 1.5e-8, -6.0e-8, -6.0e-8), \
        (88064.0, 0.0, -196608.0, -65536.0)
    tasm, jasm = td1.D1Assembler(13), jd1.D1Assembler(13)
    for fraid in (1, 2, 3):
        tx = td1.encode_subframe(fraid, 352800.0 + fraid * 6, _port(eph),
                                 IonoParams(alpha=alpha, beta=beta,
                                            valid=True))
        np.testing.assert_array_equal(tx, jd1.encode_subframe(
            fraid, 352800.0 + fraid * 6, eph,
            JIono(alpha=alpha, beta=beta, valid=True)))
        got, want = td1.decode_subframe(tx), jd1.decode_subframe(tx)
        assert got == want and got[0] == fraid
        tasm.push(got[0], got[2])
        jasm.push(want[0], want[2])
        bad = tx.copy()
        bad[45] ^= 1
        assert td1.decode_subframe(bad) is None
    assert dataclasses.asdict(tasm.ephemeris()) == \
        dataclasses.asdict(jasm.ephemeris())
    assert dataclasses.asdict(tasm.iono) == dataclasses.asdict(jasm.iono)


def test_scenario_equal_jax():
    """The four B1I satellites of tests/test_e2e_beidou.py: the same
    PRNs and satellite parameters as JAX's scenario (float64 round-off),
    and 0.1 s of its IQ within atol 1e-6."""
    from gnss_sdr_tpu.utils import scenario as jscen

    kw = dict(duration_s=30.0, n_sats=4, cn0_dbhz=48.0, fs=4.0e6)
    j = jscen.build_beidou_b1i_scenario(**kw)
    t = scenario.build_beidou_b1i_scenario(**kw)
    _same_sats(j, t)
    assert t.spec.signal == j.spec.signal and t.tow_bits_start == \
        j.tow_bits_start
    j.duration_s = t.duration_s = 0.1
    np.testing.assert_allclose(t.generate(seed=5), j.generate(seed=5),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------- tracking
CASES = {"b1i": dict(signal="B1"),
         "b1i_nh20": dict(signal="B1", extended=True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def open_loop(request):
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


def test_open_loop_matches_jax(open_loop):
    cfg, jout, tout = open_loop["cfg"], open_loop["jout"], open_loop["tout"]
    assert (cfg.n_steps, cfg.n_max, cfg.table_rate, cfg.n_taps) == \
        (102, 4064, 1, 3)
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), f"{f}: first (step, channel) differing {bad[:5]}"
    assert np.asarray(jout.valid)[:, :5].sum() >= 450
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
    if CASES[open_loop["name"]].get("extended"):
        assert tst.ext_n[[1, 3]].tolist() == [20, 20]
        assert tst.sec_len[3] == 20 and tst.sec_len[1] == 0


def test_fed_jax_sums_keep_jax_bits(open_loop):
    tst, tout = run_fed_jax_sums(open_loop)
    assert_fed_jax_sums_keep_bits(open_loop["jst"], open_loop["jout"], tst,
                                  tout)


def test_k2_wrapper_at_the_b1i_shape():
    """The GPS shape at twice the rate: one 4096-sample tile, the 2046-entry
    table and the 20-chip NH20 in the 32-entry secondary table; the cluster
    stays at one block (windows below 8192 samples)."""
    c = scenario.tracking_handoff_case("cpu", signal="B1", extended=True)
    cfg = c["cfg"]
    tk._check(cfg, chunk=torch.from_numpy(c["chunk"]),
              carry=tk.pack_carry(c["state"]),
              code_tables=torch.from_numpy(c["tables"]),
              sec_tables=torch.from_numpy(c["sec"]))
    p = tk.make_params(cfg, 6, len(c["chunk"]), 2046, 32)
    assert (p.n_steps, p.n_max, p.table_len, p.tile) == (102, 4064, 2046,
                                                        4096)
    assert tk.pick_cluster(4, 4064, lambda m: 132 // m, 132) == 1


# --------------------------------------------------------------- telemetry
def _d1_stream():
    """tests/test_telemetry_channels.py::test_beidou_d1_telemetry's prompts
    (seed 7, start 431, polarity inverted) and its ephemeris."""
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    bits = np.concatenate([jd1.encode_subframe(f, 352800.0 + 6.0 * k, eph)
                           for k, f in enumerate([1, 2, 3, 4, 5, 1, 2, 3])])
    nh = jtlm.BeidouB1ITelemetry.NH20.astype(np.float64)
    data_amp = 80.0 * (1.0 - 2.0 * bits.astype(np.float64))
    prompts = (np.repeat(data_amp, 20).reshape(-1, 20)
               * (1.0 - 2.0 * nh)[None, :]).reshape(-1)
    prompts += np.random.default_rng(7).normal(0, 18.0, len(prompts))
    return -prompts[431:]


def _feed(tlm, prompts, chunk, epoch0=0):
    e = epoch0 + np.arange(len(prompts), dtype=np.int64)
    for i in range(0, len(prompts), chunk):
        tlm.push(e[i:i + chunk], prompts[i:i + chunk])


@pytest.mark.parametrize("chunk", [137, None], ids=["blocks", "one_push"])
def test_b1i_telemetry_equal_jax(chunk):
    prompts = _d1_stream()
    t, j = ttlm.make_telemetry("B1", 13), jtlm.make_telemetry("B1", 13)
    assert isinstance(t, ttlm.BeidouB1ITelemetry)
    np.testing.assert_array_equal(t.NH20, j.NH20)
    _feed(j, prompts, 137, epoch0=55)
    _feed(t, prompts, chunk or len(prompts), epoch0=55)
    assert t.subframe_count == j.subframe_count >= 4
    assert t.bit_phase == j.bit_phase is not None
    assert t._frame_anchor_bit == j._frame_anchor_bit
    assert dataclasses.asdict(t.tow_ref) == dataclasses.asdict(j.tow_ref)
    for ep in (55, 3000, 9000):
        for chips in (0.0, 1023.5, 2045.9):
            assert t.transmit_time(ep, chips) == j.transmit_time(ep, chips)
    assert dataclasses.asdict(t.ephemeris()) == \
        dataclasses.asdict(j.ephemeris())
    assert t.sync_failed == j.sync_failed is False


def test_geo_and_b3_refused():
    """GEO PRNs 1-5 (D2) and B3I were refused before they were ported: now
    GEO PRNs get the D2 decoder and stay in a B1 receiver's pool, B3 builds
    its decoder, receiver and scenario; an SBAS PRN (>= 120 on the L1 C/A
    code, the last telemetry ported) gets the SBAS decoder."""
    for prn in (1, 5):
        assert isinstance(ttlm.make_telemetry("B1", prn),
                          ttlm.BeidouB1IGeoTelemetry)
    assert isinstance(ttlm.make_telemetry("B3", 13), ttlm.BeidouB1ITelemetry)
    g, = trx.Receiver(trx.ReceiverConfig(signal="B3", fs=12e6, n_channels=2),
                      device="cpu").groups
    assert g.code_tables.shape == (2, 10230)
    assert scenario.build_beidou_b1i_scenario(band="B3", fs=12e6
                                              ).spec.signal == "B3"
    g, = trx.Receiver(trx.ReceiverConfig(signal="B1", fs=4e6, n_channels=4,
                                         prns=(1, 3, 6, 9, 13)),
                      device="cpu").groups
    assert g.acq_pool == [1, 3, 6, 9, 13]
    assert isinstance(ttlm.make_telemetry("1C", 120), ttlm.SbasL1Telemetry)


# ------------------------------------------------------------------- RINEX
class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 6, 7, 8, 9, tzinfo=tz)


def test_beidou_rinex_byte_identical(tmp_path, monkeypatch):
    fake = types.SimpleNamespace(datetime=_Frozen, date=datetime.date,
                                 timezone=datetime.timezone,
                                 timedelta=datetime.timedelta)
    monkeypatch.setattr(jrinex, "datetime", fake)
    monkeypatch.setattr(trinex, "datetime", fake)
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    asm = jd1.D1Assembler(13)
    for fraid in (1, 2, 3):
        res = jd1.decode_subframe(jd1.encode_subframe(
            fraid, 352800.0 + 6 * fraid, eph))
        asm.push(res[0], res[2])
    d1 = asm.ephemeris()
    obs_epoch = [types.SimpleNamespace(
        prn=p, signal="B1", pseudorange_m=2.2e7 + 1e3 * p,
        carrier_phase_cycles=1.2e8 + p, doppler_hz=-987.5 + p, cn0_dbhz=46.0)
        for p in (13, 27)]
    for tag, mod, conv in (("jax", jrinex, lambda x: x),
                           ("port", trinex, _port)):
        w = mod.RinexNavWriter(tmp_path / f"{tag}.nav")
        w.write_ephemeris(conv(d1), system="C")
        w.close()
        obs = mod.RinexObsWriter(tmp_path / f"{tag}.obs", ["B1"],
                                 approx_pos=(4.8e6, 1.6e5, 4.1e6))
        obs.write_epoch(2345, 352812.5, obs_epoch)
        obs.close()
    for ext in ("nav", "obs"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    assert "C2I" in (tmp_path / "port.obs").read_text()
    got = trinex.RinexNavReader(tmp_path / "port.nav").read()
    want = jrinex.RinexNavReader(tmp_path / "jax.nav").read()
    assert list(got) == list(want) == [("C", 13)]
    assert dataclasses.asdict(got[("C", 13)]) == \
        dataclasses.asdict(want[("C", 13)])


# ------------------------------------------------------------------ config
def test_b1i_conf_binds_and_builds():
    conf = ROOT / "conf" / "beidou_b1i.conf"
    want = jini.receiver_config_from_ini(jini.FileConfiguration(conf))
    tconf = tini.FileConfiguration(conf)
    got = tini.receiver_config_from_ini(tconf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.signal, got.n_channels, got.fs) == ("B1", 6, 4.0e6)
    g, = trx.Receiver(got, device="cpu").groups
    assert g.code_tables.shape == (6, 2046)
    assert g.acq_pool == list(range(1, 38))
