"""BeiDou B3I (``signal="B3"``: 10,230 chips at 10.23 Mcps, D1 under the
NH20 overlay) and the GEO satellites' D2 (PRNs 1-5 on B1I and B3I: 500 bps,
no NH overlay) in the port against the JAX package, on the CPU:

- ``beidou_b3i_code`` for PRNs 1-37: bit for bit; the port's
  ``data/icd_tables_b3i.json`` holds JAX's ``beidou_b3i_g2_init`` entry;
- the D2 codec (models/nav/beidou_d2.py) on tests/test_nav_messages.py's
  pages: pages 1-10 encoded and decoded, the assembled ephemeris and iono,
  a corrupted page refused, and the page stream, all equal to JAX's;
- ``BeidouB1IGeoTelemetry`` on tests/test_telemetry_channels.py's D2 stream
  (seed 3, start 101, inverted polarity, epoch 77 first) in one push and in
  137-epoch blocks: the same bit phase, page anchor, page count, TOW
  reference, transmit times and ephemeris as JAX's decoder; ``make_telemetry``
  picks the same decoder class as JAX for B1 / B3, GEO / MEO PRNs;
- the B3I scenario (tests/test_e2e_beidou_b3.py's four satellites): the
  same satellites as JAX's and 0.02 s of its IQ within atol 1e-6;
- tracking: the ``"B3"`` handoff case (five satellites at 12 MSps, n_max
  12,064, 102 steps) through JAX ``track_chunk`` and the port's eager loop
  (K2's plain version) from the identical carry, plain and with the NH20
  wipe over one secondary period installed through ``set_secondary`` /
  ``set_extension``. The rules of tests/test_torch_tracking.py: int fields
  exact at every step; correlator sums as complex values, |dz| <= 1e-4 |z|
  + 1e-4; the carry's C/N0 moments within the bounds derived there; every
  other float within rtol / atol 1e-4. Fed JAX's own sums, the loop keeps
  JAX's bits. On the plain case the port's FLL runs 1-2 float32 ulps off
  JAX's carrier frequency from the second step (channel 3 at ~3065 Hz:
  the sums' block order, as on tests/test_torch_tracking.py's seed 12), so
  its sums are compared, as seed 12's are, in JAX's carrier phase: the
  phase difference the fields report is first held within ``DPHI_MAX`` =
  2^-12 Hz x 102 ms (one ulp of a carrier frequency below 4096 Hz over the
  chunk), and the port's sums are turned by it. On the NH20 case the
  carry's ``prev_prompt`` of an extended channel is the sum of its last
  window's 20 prompts, each within the sums' bound; on channel 1 (extended
  without the wipe) the unwiped NH20 flips their signs, so it is held to
  the sum of their bounds, sum_i (1e-4 |z_i| + 1e-4) (the triangle
  inequality; against one sum's bound it reads 1.11 of it) (``_window_bound``);
- RINEX: a GEO satellite's D2 ephemeris as a BeiDou navigation record and a
  ``6I`` observation header, byte for byte with JAX's writers, and the
  record read back as JAX reads it;
- the shipped ``conf/beidou_b3i.conf`` binds as JAX binds it
  and builds a receiver; B1 and B3 groups keep the GEO PRNs
  in their acquisition pools, and a GEO channel's handoff installs the D2
  decoder.

The whole B3I chain (30 s of four satellites at 12 MSps) is held on the card
by chip_smoke.py's ``b3i`` phase.
"""

import dataclasses
import datetime
import json
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.models import codes as jcodes
from gnss_sdr_tpu.models.ephemeris import IonoParams as JIono
from gnss_sdr_tpu.models.nav import beidou_d2 as jd2
from gnss_sdr_tpu.receiver import telemetry as jtlm
from gnss_sdr_tpu.receiver import tracking as jtrk
from gnss_sdr_tpu.receiver.pvt import rinex as jrinex
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.models import codes as tcodes
from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import beidou_d2 as td2
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import receiver as trx
from gnss_sdr_tpu_torch.receiver import telemetry as ttlm
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.receiver.pvt import rinex as trinex
from gnss_sdr_tpu_torch.utils import scenario

from test_lnav import sample_ephemeris
from test_torch_glonass import assert_carry_close
from test_torch_galileo_tracking import (FLOAT_FIELDS, INT_FIELDS,
                                         _jax_cfg, _jax_state,
                                         assert_fed_jax_sums_keep_bits,
                                         run_fed_jax_sums)
from test_torch_motion import _same_sats
from test_torch_tracking import DPHI_MAX, _assert_sums_close, _phase_diff

torch.set_num_threads(1)   # one thread per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _port(eph) -> KeplerEphemeris:
    return KeplerEphemeris(**dataclasses.asdict(eph))


def test_b3i_codes_equal_jax():
    for prn in range(1, 38):
        np.testing.assert_array_equal(tcodes.code_chips("B3", prn),
                                      jcodes.beidou_b3i_code(prn),
                                      err_msg=str(prn))
    port = json.loads((ROOT / "gnss_sdr_tpu_torch" / "data"
                       / "icd_tables_b3i.json").read_text())
    jax = json.loads((ROOT / "gnss_sdr_tpu" / "data"
                      / "icd_tables.json").read_text())
    assert port == {"beidou_b3i_g2_init": jax["beidou_b3i_g2_init"]}


# ------------------------------------------------------------------- D2
def _iono(cls):
    return cls(alpha=(1.2e-8, 1.5e-8, -6.0e-8, -6.0e-8),
               beta=(88064.0, 0.0, -196608.0, -65536.0), valid=True)


def test_d2_codec_equal_jax():
    """tests/test_nav_messages.py::test_d2_page_roundtrip's pages through
    both packages' codecs."""
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    tasm, jasm = td2.D2Assembler(3), jd2.D2Assembler(3)
    for pnum in range(1, 11):
        tx = td2.encode_page(pnum, 352800.0, _port(eph), _iono(IonoParams))
        np.testing.assert_array_equal(
            tx, jd2.encode_page(pnum, 352800.0, eph, _iono(JIono)))
        got, want = td2.decode_page(tx), jd2.decode_page(tx)
        assert got == want and got[0] == pnum
        tasm.push(got[0], got[2])
        jasm.push(want[0], want[2])
        bad = tx.copy()
        bad[40] ^= 1
        bad[41] ^= 1
        assert td2.decode_page(bad) is None and jd2.decode_page(bad) is None
    assert dataclasses.asdict(tasm.ephemeris()) == \
        dataclasses.asdict(jasm.ephemeris())
    assert dataclasses.asdict(tasm.iono) == dataclasses.asdict(jasm.iono)
    np.testing.assert_array_equal(
        td2.encode_stream(_port(eph), 352800.0, 23, _iono(IonoParams)),
        jd2.encode_stream(eph, 352800.0, 23, _iono(JIono)))


# --------------------------------------------------------------- telemetry
def _d2_prompts():
    """tests/test_telemetry_channels.py::test_beidou_d2_geo_telemetry's
    prompts (seed 3, start 101, polarity inverted)."""
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    bits = jd2.encode_stream(eph, 352800.0, n_pages=14)
    prompts = np.repeat(70.0 * (1.0 - 2.0 * bits.astype(np.float64)), 2)
    rng = np.random.default_rng(3)
    return -(prompts + rng.normal(0, 14.0, len(prompts)))[101:]


def _feed(tlm, prompts, chunk, epoch0=0):
    e = epoch0 + np.arange(len(prompts), dtype=np.int64)
    for i in range(0, len(prompts), chunk):
        tlm.push(e[i:i + chunk], prompts[i:i + chunk])


@pytest.mark.parametrize("chunk", [137, None], ids=["blocks", "one_push"])
def test_d2_telemetry_equal_jax(chunk):
    prompts = _d2_prompts()
    for sig in ("B1", "B3"):
        t, j = ttlm.make_telemetry(sig, 3), jtlm.make_telemetry(sig, 3)
        assert isinstance(t, ttlm.BeidouB1IGeoTelemetry)
        _feed(j, prompts, 137, epoch0=77)
        _feed(t, prompts, chunk or len(prompts), epoch0=77)
        assert t.page_count == j.page_count >= 10
        assert t.bit_phase == j.bit_phase is not None
        assert t._anchor == j._anchor and t._polarity == j._polarity
        assert dataclasses.asdict(t.tow_ref) == dataclasses.asdict(j.tow_ref)
        for ep in (77, 3000, 9000):
            for chips in (0.0, 1023.5, 2045.9):
                assert t.transmit_time(ep, chips) == \
                    j.transmit_time(ep, chips)
        assert dataclasses.asdict(t.ephemeris()) == \
            dataclasses.asdict(j.ephemeris())


def test_make_telemetry_as_jax():
    """B1 / B3, GEO / MEO: the decoder class JAX picks; on the L1 C/A code
    too, SBAS PRNs (>= 120) included."""
    for sig in ("B1", "B3"):
        for prn in (1, 3, 5, 6, 13, 37):
            assert type(ttlm.make_telemetry(sig, prn)).__name__ == \
                type(jtlm.make_telemetry(sig, prn)).__name__
    for sig, prn in (("1G", 1), ("2G", 24)):
        assert type(ttlm.make_telemetry(sig, prn)).__name__ == \
            type(jtlm.make_telemetry(sig, prn)).__name__
    for prn in (5, 120, 123, 138):
        assert type(ttlm.make_telemetry("1C", prn)).__name__ == \
            type(jtlm.make_telemetry("1C", prn)).__name__


# ---------------------------------------------------------------- scenario
def test_b3i_scenario_equal_jax():
    """The four B3I satellites of tests/test_e2e_beidou_b3.py: the same PRNs
    and satellite parameters as JAX's scenario (float64 round-off), and
    0.02 s of its IQ within atol 1e-6."""
    from gnss_sdr_tpu.utils import scenario as jscen

    kw = dict(duration_s=30.0, n_sats=4, cn0_dbhz=48.0, fs=12.0e6,
              band="B3")
    j = jscen.build_beidou_b1i_scenario(**kw)
    t = scenario.build_beidou_b1i_scenario(**kw)
    _same_sats(j, t)
    assert t.spec.signal == j.spec.signal == "B3"
    assert t.tow_bits_start == j.tow_bits_start
    j.duration_s = t.duration_s = 0.02
    np.testing.assert_allclose(t.generate(seed=5), j.generate(seed=5),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------- tracking
CASES = {"b3i": dict(signal="B3"),
         "b3i_nh20": dict(signal="B3", extended=True)}
# cases whose sums are compared in JAX's carrier phase (module docstring)
ROTATED = ("b3i",)


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
        (102, 12064, 1, 3)
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(jout, f)), getattr(tout, f).numpy()
        bad = np.argwhere(a != b)
        assert not len(bad), f"{f}: first (step, channel) differing {bad[:5]}"
    assert np.asarray(jout.valid)[:, :5].sum() >= 450
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    jst, tst = open_loop["jst"], ttrk.state_to_numpy(open_loop["tst"])
    steps = _phase_diff(jout.carr_phase_cycles, jout.carr_phase_frac,
                        tout.carr_phase_cycles, tout.carr_phase_frac)
    carry = _phase_diff(jst.carr_phase_cycles, jst.carr_phase_frac,
                        tst.carr_phase_cycles, tst.carr_phase_frac)
    if open_loop["name"] in ROTATED:
        assert max(np.abs(steps).max(), np.abs(carry).max()) <= DPHI_MAX
    else:
        steps, carry = np.zeros_like(steps), None
    _assert_sums_close(np.asarray(jout.prompt), tout.prompt.numpy(), steps,
                       "prompt")
    _assert_sums_close(np.asarray(jout.correlators),
                       tout.correlators.numpy(), steps[..., None],
                       "correlators")
    assert_carry_close(jst, tst, carry, _window_bound(open_loop))
    if CASES[open_loop["name"]].get("extended"):
        assert tst.ext_n[[1, 3]].tolist() == [20, 20]
        assert tst.sec_len[3] == 20 and tst.sec_len[1] == 0


def _window_bound(open_loop):
    """Per channel, the bound on ``prev_prompt``: one sum's, 1e-4 |z| + 1e-4,
    on a channel that updates every epoch; on an extended one the sum of the
    bounds of the prompts its last window accumulated (module docstring)."""
    jst, jout, cfg = open_loop["jst"], open_loop["jout"], open_loop["cfg"]
    prev = np.asarray(jst.prev_prompt, np.float64)
    bound = 1e-4 * np.hypot(prev[:, 0], prev[:, 1]) + 1e-4
    p = np.asarray(jout.correlators, np.float64)[:, :, cfg.data_prompt_index]
    mag = np.hypot(p[..., 0], p[..., 1])
    valid, eidx = np.asarray(jout.valid), np.asarray(jout.epoch_index)
    for ch in np.flatnonzero(np.asarray(jst.ext_n) > 1):
        n, anchor = int(jst.ext_n[ch]), int(jst.ext_anchor[ch])
        ends = np.flatnonzero(valid[:, ch]
                              & ((eidx[:, ch] - anchor) % n == n - 1))
        window = [s for s in range(ends[-1] - n + 1, ends[-1] + 1)
                  if valid[s, ch]]
        assert len(window) == n
        bound[ch] = np.sum(1e-4 * mag[window, ch] + 1e-4)
    return bound


def test_fed_jax_sums_keep_jax_bits(open_loop):
    tst, tout = run_fed_jax_sums(open_loop)
    assert_fed_jax_sums_keep_bits(open_loop["jst"], open_loop["jout"], tst,
                                  tout)


def test_k2_wrapper_at_the_b3i_shape():
    """E5a's data shape with the 20-chip NH20 in the 32-entry secondary
    table: three 4096-sample tiles per epoch, the 10,230-entry table in
    shared memory."""
    c = scenario.tracking_handoff_case("cpu", signal="B3", extended=True)
    cfg = c["cfg"]
    tk._check(cfg, chunk=torch.from_numpy(c["chunk"]),
              carry=tk.pack_carry(c["state"]),
              code_tables=torch.from_numpy(c["tables"]),
              sec_tables=torch.from_numpy(c["sec"]))
    p = tk.make_params(cfg, 6, len(c["chunk"]), 10230, 32)
    assert (p.n_steps, p.n_max, p.table_len, p.tile) == (102, 12064, 10230,
                                                        tk.TILE_MAX)
    assert -(-p.n_max // p.tile) == 3
    assert tk.shared_bytes(12064, 10230, 1) < tk.MAX_SMEM_BYTES
    assert tk.pick_cluster(4, 12064, lambda m: 132 // m, 132) == 8


# ------------------------------------------------------------------- RINEX
class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 6, 7, 8, 9, tzinfo=tz)


def test_geo_rinex_byte_identical(tmp_path, monkeypatch):
    fake = types.SimpleNamespace(datetime=_Frozen, date=datetime.date,
                                 timezone=datetime.timezone,
                                 timedelta=datetime.timedelta)
    monkeypatch.setattr(jrinex, "datetime", fake)
    monkeypatch.setattr(trinex, "datetime", fake)
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    asm = jd2.D2Assembler(3)
    for pnum in range(1, 11):
        res = jd2.decode_page(jd2.encode_page(pnum, 352800.0, eph))
        asm.push(res[0], res[2])
    d2 = asm.ephemeris()
    obs_epoch = [types.SimpleNamespace(
        prn=p, signal="B3", pseudorange_m=3.6e7 + 1e3 * p,
        carrier_phase_cycles=1.9e8 + p, doppler_hz=-12.5 + p, cn0_dbhz=44.0)
        for p in (3, 13)]
    for tag, mod, conv in (("jax", jrinex, lambda x: x),
                           ("port", trinex, _port)):
        w = mod.RinexNavWriter(tmp_path / f"{tag}.nav")
        w.write_ephemeris(conv(d2), system="C")
        w.close()
        obs = mod.RinexObsWriter(tmp_path / f"{tag}.obs", ["B3"],
                                 approx_pos=(4.8e6, 1.6e5, 4.1e6))
        obs.write_epoch(2345, 352812.5, obs_epoch)
        obs.close()
    for ext in ("nav", "obs"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    assert "C6I" in (tmp_path / "port.obs").read_text()
    got = trinex.RinexNavReader(tmp_path / "port.nav").read()
    want = jrinex.RinexNavReader(tmp_path / "jax.nav").read()
    assert list(got) == list(want) == [("C", 3)]
    assert dataclasses.asdict(got[("C", 3)]) == \
        dataclasses.asdict(want[("C", 3)])


# ------------------------------------------------------------------ config
def test_b3i_conf_binds_and_builds():
    conf = ROOT / "conf" / "beidou_b3i.conf"
    want = jini.receiver_config_from_ini(jini.FileConfiguration(conf))
    tconf = tini.FileConfiguration(conf)
    got = tini.receiver_config_from_ini(tconf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.signal, got.n_channels, got.fs) == ("B3", 5, 12.0e6)
    g, = trx.Receiver(got, device="cpu").groups
    assert g.code_tables.shape == (5, 10230)
    assert g.acq_pool == list(range(1, 38))


@pytest.mark.parametrize("signal,fs", [("B1", 4.0e6), ("B3", 12.0e6)])
def test_geo_prns_acquired_with_d2(signal, fs):
    """A BeiDou group keeps GEO PRNs 1-5 in its pool, as JAX's does, and a
    GEO channel's handoff installs the D2 decoder (a MEO one D1)."""
    rx = trx.Receiver(trx.ReceiverConfig(signal=signal, fs=fs, n_channels=2,
                                         prns=(1, 3, 6, 9, 13)),
                      device="cpu")
    g, = rx.groups
    assert g.acq_pool == [1, 3, 6, 9, 13]
    for ch, prn in zip(g.channels, (3, 13)):
        rx._assign_channel(g, ch, prn, 100, 250.0)
    assert isinstance(g.channels[0].telemetry, ttlm.BeidouB1IGeoTelemetry)
    assert isinstance(g.channels[1].telemetry, ttlm.BeidouB1ITelemetry)
    st = ttrk.state_to_numpy(g.trk_state)
    assert st.active[:2].all() and (st.if_freq[:2] == 0.0).all()
