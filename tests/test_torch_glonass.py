"""GLONASS L1 / L2 C/A (``signal="1G"`` / ``"2G"``: FDMA, each satellite at
its frequency slot's IF) in the port against the JAX package, on the CPU:

- ``glonass_ca_code``: the one 511-chip code of every slot, bit for bit;
- the GNAV codec (models/nav/glonass_gnav.py) on tests/test_nav_messages.py's
  cases: strings 1-5 and an almanac pair encoded and decoded, a Hamming
  error refused, the frame stream equal, the assembled ephemeris, UTC and
  almanac equal; ``GlonassEphemeris.position_velocity`` (RK4) over +-15 min
  within 1e-6 m of JAX's;
- ``GlonassL1CaTelemetry`` on tests/test_telemetry_channels.py's GNAV stream
  (seed 5, start 1234, epoch 777 first) in one push and in 137-epoch
  blocks: the same slot phase, time-mark anchor, string count, tk
  reference, transmit times and ephemeris as JAX's decoder;
- the scenarios of tests/test_e2e_glonass{,_l2}.py: the same satellites,
  slots and state vectors as JAX's, and 0.02 s of their IQ;
- FDMA acquisition: a 0.2 s capture with satellites at slots -7 and +6
  (PRNs 10 and 4) through the port receiver's slot-centred PCPS
  (``Receiver._pcps``, one ``pcps_search_grids`` call) against JAX's
  ``pcps_search_grids`` on its own grids and replicas: the same code phase
  and Doppler bin, the residual Doppler from the slot IF within 1e-3 Hz;
  the handoff starts each channel at its slot IF;
- tracking: the ``"1G"`` / ``"2G"`` handoff cases (five satellites at 8 / 6
  MSps on slots that include -7, 0 and +6: |IF| up to 3.94 MHz) through JAX
  ``track_chunk`` and the port's eager loop from the identical carry, which
  ``state_from_numpy`` carries across with a non-zero IF on every live
  channel but one. The rules of tests/test_torch_tracking.py: int fields
  exact at every step; correlator sums (every tap, the prompt, the carry's
  ``prev_prompt`` and ``acc_corr``) as complex values, |dz| <= 1e-4 |z| +
  1e-4; the carry's C/N0 moments within the bounds derived there from the
  prompts' (``moment_bounds``); every other float within rtol / atol 1e-4.
  Fed JAX's own sums, the loop keeps JAX's bits;
- observables: both packages' engines on 20 s of epoch records of two
  channels at slot IFs -3.94 / +3.38 MHz, every observable equal;
- RINEX: a GNAV ephemeris as a GLONASS navigation record (geph) and a
  ``1C`` / ``2C`` GLONASS observation header, byte for byte with JAX's
  writers (creation clock frozen), and the record read back as JAX reads it;
- the shipped ``conf/glonass_l1.conf`` and ``conf/glonass_l2.conf`` bind as
  JAX binds them and build receivers whose groups
  place each PRN at its slot.

The whole GLONASS chains (the JAX e2e tests' scenarios) are held on the card
by chip_smoke.py's ``glo_l1`` and ``glo_l2`` phases.
"""

import dataclasses
import datetime
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu import constants as jconst
from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.models import codes as jcodes
from gnss_sdr_tpu.models.nav import glonass_gnav as jgn
from gnss_sdr_tpu.ops import acquisition as jacq
from gnss_sdr_tpu.receiver import telemetry as jtlm
from gnss_sdr_tpu.receiver import tracking as jtrk
from gnss_sdr_tpu.receiver.pvt import rinex as jrinex
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.models import codes as tcodes
from gnss_sdr_tpu_torch.models.almanac import GlonassAlmanac
from gnss_sdr_tpu_torch.models.nav import glonass_gnav as tgn
from gnss_sdr_tpu_torch.receiver import receiver as trx
from gnss_sdr_tpu_torch.receiver import telemetry as ttlm
from gnss_sdr_tpu_torch.receiver import tracking as ttrk
from gnss_sdr_tpu_torch.receiver.pvt import rinex as trinex
from gnss_sdr_tpu_torch.utils import generator, scenario

from test_torch_motion import _same_sats
from test_torch_galileo_tracking import (FLOAT_FIELDS, INT_FIELDS,
                                         _complex_close, _jax_cfg,
                                         _jax_state,
                                         assert_fed_jax_sums_keep_bits,
                                         moment_bounds, run_fed_jax_sums)

torch.set_num_threads(1)   # one thread per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMPLEX_CARRY = ("acc_corr", "prev_prompt")


def test_glonass_code_equal_jax():
    want = jcodes.glonass_ca_code()
    for sig in ("1G", "2G"):
        for prn in (1, 10, 24):
            np.testing.assert_array_equal(tcodes.code_chips(sig, prn), want)
    assert len(want) == 511


# ------------------------------------------------------------------- GNAV
def _sample_eph(mod):
    # tests/test_nav_messages.py::glonass_sample_eph
    return mod.GlonassEphemeris(
        slot=5, freq_slot=1, tb_s=11700.0,
        pos_m=(10521358.3, 15037252.1, 17452812.9),
        vel_m_s=(-1324.25, 2145.73, -1054.12),
        acc_m_s2=(1.86e-6, -0.93e-6, 2.79e-6),
        gamma_n=6.4e-10, tau_n=-8.3e-5, health=0)


def _utc(mod):
    # tests/test_nav_messages.py::test_gnav_string5_utc_roundtrip
    return mod.GlonassUtc(tau_c=-9.3132257462e-09, tau_gps=1.3969838619e-08,
                          n4=7, day_na=851, l_n=0, valid=True)


def _almanac(cls):
    return cls(slot=9, freq_slot=-7, health=1, lambda_n=-0.71,
               t_lambda=33210.5, delta_i=0.0123, ecc=0.00042,
               omega_n=1.234, delta_t=-2655.3, delta_t_dot=0.0012,
               tau_n=-3.1e-5)


def test_gnav_codec_equal_jax():
    """Strings 1-5 and an almanac pair: the same bits from both encoders,
    the same fields from both decoders, the same assembled ephemeris, UTC
    and almanac; a flipped bit fails the Hamming check in both."""
    from gnss_sdr_tpu.models.almanac import GlonassAlmanac as JAlmanac

    teph, jeph = _sample_eph(tgn), _sample_eph(jgn)
    tasm, jasm = tgn.GnavAssembler(5), jgn.GnavAssembler(5)
    strings = [(tgn.encode_string(sid, teph, utc=_utc(tgn)),
                jgn.encode_string(sid, jeph, utc=_utc(jgn)))
               for sid in (1, 2, 3, 4, 5)]
    strings.append((tgn.encode_almanac_pair(6, _almanac(GlonassAlmanac)),
                    jgn.encode_almanac_pair(6, _almanac(JAlmanac))))
    flat = [(t, j) for t, j in strings[:5]] + list(zip(*strings[5]))
    for t, j in flat:
        np.testing.assert_array_equal(t, j)
        assert tgn.hamming_check(t)
        got, want = tgn.decode_string(t), jgn.decode_string(t)
        assert got == want and got is not None
        tasm.push(*got)
        jasm.push(*want)
        for pos in (3, 40, 84):
            bad = t.copy()
            bad[pos] ^= 1
            assert tgn.decode_string(bad) is None
            assert jgn.decode_string(bad) is None
    assert dataclasses.asdict(tasm.ephemeris()) == \
        dataclasses.asdict(jasm.ephemeris())
    assert dataclasses.asdict(tasm.utc_glo) == dataclasses.asdict(jasm.utc_glo)
    assert tasm.utc_glo.valid and list(tasm.almanacs) == [9]
    assert dataclasses.asdict(tasm.almanacs[9]) == \
        dataclasses.asdict(jasm.almanacs[9])


def test_gnav_streams_equal_jax():
    teph, jeph = _sample_eph(tgn), _sample_eph(jgn)
    from gnss_sdr_tpu.models.almanac import GlonassAlmanac as JAlmanac
    np.testing.assert_array_equal(
        tgn.encode_frame_stream(teph, 11670.0, 2,
                                almanacs=[_almanac(GlonassAlmanac)],
                                utc=_utc(tgn)),
        jgn.encode_frame_stream(jeph, 11670.0, 2,
                                almanacs=[_almanac(JAlmanac)],
                                utc=_utc(jgn)))
    np.testing.assert_array_equal(tgn.encode_frame_stream(teph, 11700.0, 1),
                                  jgn.encode_frame_stream(jeph, 11700.0, 1))
    np.testing.assert_array_equal(tgn.encode_symbol_stream(teph, 2),
                                  jgn.encode_symbol_stream(jeph, 2))
    np.testing.assert_array_equal(tgn.TIME_MARK, jgn.TIME_MARK)


@pytest.mark.parametrize("dt", [-900.0, -37.5, 0.0, 610.0, 900.0])
def test_glonass_orbit_equal_jax(dt):
    teph, jeph = _sample_eph(tgn), _sample_eph(jgn)
    tp, tv = teph.position_velocity(teph.tb_s + dt)
    jp, jv = jeph.position_velocity(jeph.tb_s + dt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9)
    assert teph.clock_offset(teph.tb_s + dt) == \
        jeph.clock_offset(jeph.tb_s + dt)
    ta = _almanac(GlonassAlmanac)
    from gnss_sdr_tpu.models.almanac import GlonassAlmanac as JAlmanac
    for a, b in zip(ta.position_velocity(33210.5 + dt),
                    _almanac(JAlmanac).position_velocity(33210.5 + dt)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- telemetry
def _gnav_prompts():
    """tests/test_telemetry_channels.py::test_glonass_gnav_telemetry's
    prompts (seed 5) from start 1234 on, and its ephemeris."""
    eph = jgn.GlonassEphemeris(
        slot=5, tb_s=11700.0, pos_m=(1.0e7, 1.5e7, 1.7e7),
        vel_m_s=(-1324.25, 2145.73, -1054.12),
        acc_m_s2=(1.9e-6, -0.9e-6, 2.8e-6), gamma_n=6.4e-10, tau_n=-8.3e-5)
    sym = jgn.encode_symbol_stream(eph, n_frames=3)
    rng = np.random.default_rng(5)
    slot_amp = 90.0 * (1.0 - 2.0 * sym.astype(np.float64))
    prompts = np.repeat(slot_amp, 10) + rng.normal(0, 25.0, len(sym) * 10)
    return prompts[1234:], eph


def _feed(tlm, prompts, chunk, epoch0=0):
    e = epoch0 + np.arange(len(prompts), dtype=np.int64)
    for i in range(0, len(prompts), chunk):
        tlm.push(e[i:i + chunk], prompts[i:i + chunk])


@pytest.mark.parametrize("chunk", [137, None], ids=["blocks", "one_push"])
def test_gnav_telemetry_equal_jax(chunk):
    prompts, eph = _gnav_prompts()
    for sig in ("1G", "2G"):
        t, j = ttlm.make_telemetry(sig, 5), jtlm.make_telemetry(sig, 5)
        assert isinstance(t, ttlm.GlonassL1CaTelemetry)
        _feed(j, prompts, 137, epoch0=777)
        _feed(t, prompts, chunk or len(prompts), epoch0=777)
        assert t.string_count == j.string_count >= 8
        assert t._anchor == j._anchor and t._phase == j._phase
        assert t._decoded_upto == j._decoded_upto
        assert t.tk_ref == j.tk_ref is not None and t.have_tow
        for ep in (777, 5000, 20000):
            for chips in (0.0, 255.5, 510.9):
                assert t.transmit_time(ep, chips) == \
                    j.transmit_time(ep, chips)
        assert dataclasses.asdict(t.ephemeris()) == \
            dataclasses.asdict(j.ephemeris())
        np.testing.assert_allclose(t.ephemeris().pos_m, eph.pos_m, atol=0.5)


# ---------------------------------------------------------------- scenario
@pytest.mark.parametrize("band,n_sats,fs", [("1G", 5, 8.0e6),
                                            ("2G", 4, 6.0e6)])
def test_glonass_scenario_equal_jax(band, n_sats, fs):
    """tests/test_e2e_glonass{,_l2}.py's scenarios: the same slots,
    satellites, state vectors and frame origin as JAX's, and 0.02 s of the
    IQ (each satellite at its slot IF, one noise floor) within atol 1e-6 of
    JAX's generator summed the same way."""
    from gnss_sdr_tpu.utils import generator as jgen
    from gnss_sdr_tpu.utils import scenario as jscen

    kw = dict(fs=fs, n_sats=n_sats, cn0_dbhz=48.0, band=band)
    j = jscen.build_glonass_l1_scenario(**kw)
    t = scenario.build_glonass_l1_scenario(**kw)
    _same_sats(j, t)
    assert (t.spec.signal, t.tow_bits_start, t.duration_s) == \
        (j.spec.signal, j.tow_bits_start, j.duration_s)
    assert list(t.ephemerides) == list(j.ephemerides)
    for key, eph in t.ephemerides.items():
        assert dataclasses.asdict(eph) == \
            dataclasses.asdict(j.ephemerides[key])
    t.duration_s = 0.02
    n = int(round(fs * 0.02))
    slots = trx.ReceiverConfig().glonass_freq_slots
    want = np.zeros(n, np.complex64)
    for sp in j.sats:
        want = want + jgen.generate(j.spec, [sp], fs, 0.02, noise=False,
                                    if_freq_hz=slots[sp.prn - 1]
                                    * j.spec.fdma_step_hz)
    rng = np.random.default_rng(5)
    want = want + (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        / np.sqrt(2.0)
    np.testing.assert_allclose(t.generate(seed=5), want.astype(np.complex64),
                               rtol=0, atol=1e-6)


# -------------------------------------------------------- FDMA acquisition
def test_fdma_acquisition_equal_jax():
    """Two satellites at the band's ends (PRN 10 at slot -7, PRN 4 at +6;
    PRN 1 at +1 is absent): the port receiver's slot-centred search against
    JAX's ``pcps_search_grids`` on the same grids."""
    from gnss_sdr_tpu.receiver import receiver as jrx

    fs, prns = 8.0e6, (1, 4, 10)
    spec = constants.GLONASS_L1_CA
    slots = trx.ReceiverConfig().glonass_freq_slots
    sats = [generator.SatParams(prn=10, cn0_dbhz=47.0, doppler_hz=-1830.0,
                                code_delay_s=3.1e-4),
            generator.SatParams(prn=4, cn0_dbhz=46.0, doppler_hz=2290.0,
                                code_delay_s=7.7e-4)]
    x = sum(generator.generate(spec, [sp], fs, 0.2, noise=False,
                               if_freq_hz=slots[sp.prn - 1]
                               * spec.fdma_step_hz) for sp in sats)
    rng = np.random.default_rng(23)
    x = (x + (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
         / np.sqrt(2.0)).astype(np.complex64)
    kw = dict(signal="1G", fs=fs, n_channels=3, prns=prns,
              acq_doppler_max_hz=5000.0, acq_doppler_step_hz=250.0)
    rx = trx.Receiver(trx.ReceiverConfig(**kw), device="cpu")
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw))
    g, jg = rx.groups[0], jr.groups[0]
    assert [g.if_freq_for(p) for p in prns] == \
        [jg.if_freq_for(p) for p in prns] == [562500.0, 3375000.0, -3937500.0]
    assert [g.carrier_freq_for(p) for p in prns] == \
        [jg.carrier_freq_for(p) for p in prns]
    window, slab = rx._acq_window(g)
    assert (window, slab) == jr._acq_window(jg, "pcps")
    nc = g.rx_cfg.acq_noncoherent
    head = x[: (nc - 1) * slab + window]
    spchip = int(np.ceil(fs / spec.code_rate_cps))
    dopplers = jacq.make_doppler_grid(5000.0, 250.0)
    stride = slab if slab != window else None
    res = rx._pcps(g, list(prns), torch.from_numpy(head), dopplers, spchip,
                   nc, stride)
    centers = np.array([jg.if_freq_for(p) for p in prns], np.float32)
    jres = jacq.pcps_search_grids(
        jnp.asarray(head), jnp.asarray(np.stack([jr._code_fft(jg, p)
                                                 for p in prns])),
        jnp.asarray(centers[:, None] + dopplers[None, :]), fs=fs,
        samples_per_code=g.spc, samples_per_chip=spchip, noncoherent=nc,
        stride=stride)
    np.testing.assert_array_equal(res.code_phase.numpy(),
                                  np.asarray(jres.code_phase))
    want = [float(v) - float(c) for v, c in zip(jres.doppler_hz, centers)]
    np.testing.assert_allclose(res.doppler_hz.numpy(), want, rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(res.test_cfar.numpy(),
                               np.asarray(jres.test_cfar), rtol=1e-3)
    cfar = res.test_cfar.numpy()
    assert cfar[1] > g.rx_cfg.acq_threshold_cfar > cfar[0]
    assert cfar[2] > g.rx_cfg.acq_threshold_cfar
    assert abs(want[1] - 2290.0) <= 125.0 and abs(want[2] + 1830.0) <= 125.0
    # the handoff: each acquired channel starts at its slot IF
    chunk = x[: g.rx_cfg.chunk_ms * int(fs) // 1000]
    rx._run_acquisition(g, chunk, torch.from_numpy(
        np.stack([chunk.real, chunk.imag], -1)))
    st = ttrk.state_to_numpy(g.trk_state)
    got = {ch.prn: ch.ch_id for ch in g.channels if ch.state == "tracking"}
    assert sorted(got) == [4, 10]
    for prn, ch in got.items():
        assert st.if_freq[ch] == np.float32(g.if_freq_for(prn))
        assert abs(st.carrier_freq[ch] - st.if_freq[ch]
                   - (2290.0 if prn == 4 else -1830.0)) <= 125.0


# ---------------------------------------------------------------- tracking
CASES = {"glo_l1": dict(signal="1G"), "glo_l2": dict(signal="2G")}


@pytest.fixture(scope="module", params=sorted(CASES))
def open_loop(request):
    c = scenario.tracking_handoff_case("cpu", **CASES[request.param])
    cfg = c["cfg"]
    jst, jout = jtrk.track_chunk(
        _jax_cfg(cfg), jnp.asarray(c["chunk"]), _jax_state(c["state"]),
        jnp.asarray(c["tables"]), None)
    tst, tout = ttrk.track_chunk(
        cfg, torch.from_numpy(c["chunk"]), c["state"],
        torch.from_numpy(c["tables"]), None)
    return dict(name=request.param, cfg=cfg, jst=jst, jout=jout, tst=tst,
                tout=tout, case=c)


def test_handoff_carries_the_slot_ifs(open_loop):
    """The carry JAX starts from holds every channel's slot IF (k = -7, 0
    and +6 among them), as the port's does."""
    signal = CASES[open_loop["name"]]["signal"]
    step = constants.SIGNALS[signal].fdma_step_hz
    want = np.array(list(scenario._HANDOFF_SLOTS[signal]) + [0],
                    np.float32) * np.float32(step)
    n = ttrk.state_to_numpy(open_loop["case"]["state"])
    np.testing.assert_array_equal(n.if_freq, want)
    np.testing.assert_array_equal(
        np.asarray(_jax_state(open_loop["case"]["state"]).if_freq), want)
    assert {-7, 0, 6} <= set(scenario._HANDOFF_SLOTS[signal])
    np.testing.assert_array_equal(np.asarray(open_loop["jst"].if_freq), want)
    np.testing.assert_array_equal(
        ttrk.state_to_numpy(ttrk.state_from_numpy(n, "cpu")).if_freq, want)


def test_observables_at_slot_ifs_equal_jax():
    """Both packages' observables engines (carrier smoothing 100, as the
    GLONASS e2e tests run them) on the same 20 s of epoch records of two
    channels at slot IFs -3.9375 and +3.375 MHz, their float32 NCO fields
    advanced as the loop advances them: every observable of every 20 ms
    tick equal, the carrier phase term nco - IF * tick / fs (float64 on the
    host) included."""
    from gnss_sdr_tpu.receiver import observables as jobs
    from gnss_sdr_tpu_torch.receiver import observables as tobs

    fs, spc = 8.0e6, 8000
    engines = [m.ObservablesEngine(fs, carrier_smoothing_factor=100)
               for m in (jobs, tobs)]

    class Tlm:                       # a GNAV channel after its tk sync
        have_tow = True
        half_cycle = 0.0

        def __init__(self, tk, e0):
            self.tk, self.e0 = tk, e0

        def transmit_time(self, epoch, chips, code_len=511, code_rate=0.511e6):
            return self.tk + ((epoch - self.e0) * code_len + chips) / code_rate

    chans = [dict(prn=10, if_freq=-3937500.0, dop=-1830.25, tk=40230.0),
             dict(prn=4, if_freq=3375000.0, dop=2290.5, tk=40230.013)]
    for c in chans:
        c["tlm"] = Tlm(c["tk"], 7)
    for tick in range(spc * 20, spc * 20000, 160000):
        for eng, mod in zip(engines, (jobs, tobs)):
            chs = []
            for c in chans:
                e = tick // spc - 1
                f = np.float32(c["if_freq"] + c["dop"])
                cyc = np.float64(f) * e * spc / fs
                chs.append(dict(
                    prn=c["prn"], signal="1G", code_len=511,
                    code_rate=0.511e6, if_freq=c["if_freq"],
                    carrier_freq=constants.glonass_carrier_hz(
                        constants.GLONASS_L1_CA, -7 if c["prn"] == 10 else 6),
                    record=mod.EpochRecord(
                        abs_start_sample=e * spc, epoch_index=e,
                        rem_code_phase=float(np.float32(0.25)),
                        code_freq=float(np.float32(511000.4)),
                        carrier_freq=float(f),
                        carr_phase_cycles=int(np.floor(cyc)),
                        carr_phase_frac=float(np.float32(cyc % 1.0)),
                        cn0_dbhz=45.0),
                    telemetry=c["tlm"]))
            c_out = eng.compute(tick, chs)
            if mod is jobs:
                want = c_out
            else:
                got = c_out
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_open_loop_matches_jax(open_loop):
    cfg, jout, tout = open_loop["cfg"], open_loop["jout"], open_loop["tout"]
    n_max = {"glo_l1": 8064, "glo_l2": 6064}[open_loop["name"]]
    assert (cfg.n_steps, cfg.n_max, cfg.table_rate, cfg.n_taps) == \
        (102, n_max, 1, 3)
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
    assert_carry_close(open_loop["jst"],
                       ttrk.state_to_numpy(open_loop["tst"]))


def assert_carry_close(jst, tst, dphi=None, prev_bound=None):
    """The final carries: int fields equal; ``prev_prompt`` and ``acc_corr``
    as complex sums (turned by ``dphi`` cycles, a per-channel phase
    difference, where one is given), |dz| <= 1e-4 |z| + 1e-4 (``prev_prompt``
    within ``prev_bound`` [C] instead, where that is given); the C/N0
    moments ``ema_i2_minus_q2`` and ``ema_abs_i`` within the bounds that
    tests/test_torch_tracking.py derives from the prompts' (``moment_bounds``
    with e = 1e-4 + 2 pi max |dphi|, as tests/test_torch_wideband_tracking.py
    holds them); every other float within rtol / atol 1e-4."""
    e = 1e-4
    for name in COMPLEX_CARRY:
        a, b = np.asarray(getattr(jst, name)), getattr(tst, name)
        if dphi is not None:
            z = (b[..., 0] + 1j * b[..., 1]) * np.exp(2j * np.pi * dphi.reshape(
                dphi.shape + (1,) * (b.ndim - 2)))
            b = np.stack([z.real, z.imag], -1)
            e = 1e-4 + 2 * np.pi * np.abs(dphi).max()
        if name == "prev_prompt" and prev_bound is not None:
            err = np.abs((b[..., 0] - a[..., 0]) + 1j * (b[..., 1] - a[..., 1]))
            assert (err <= prev_bound).all(), (name, err / prev_bound)
            continue
        _complex_close(a, b)
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
            elif field in ("ema_i2_minus_q2", "ema_abs_i"):
                bound = moment_bounds(jst.cn0.ema_i2_plus_q2, e)[field]
                assert (np.abs(y - x) <= bound).all(), \
                    (field, np.abs(y - x) / bound)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name}.{field}")


def test_fed_jax_sums_keep_jax_bits(open_loop):
    tst, tout = run_fed_jax_sums(open_loop)
    assert_fed_jax_sums_keep_bits(open_loop["jst"], open_loop["jout"], tst,
                                  tout)


# ------------------------------------------------------------------- RINEX
class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 6, 7, 8, 9, tzinfo=tz)


def test_glonass_rinex_byte_identical(tmp_path, monkeypatch):
    fake = types.SimpleNamespace(datetime=_Frozen, date=datetime.date,
                                 timezone=datetime.timezone,
                                 timedelta=datetime.timedelta)
    monkeypatch.setattr(jrinex, "datetime", fake)
    monkeypatch.setattr(trinex, "datetime", fake)
    asm = jgn.GnavAssembler(5)
    for sid in (1, 2, 3, 4):
        asm.push(*jgn.decode_string(jgn.encode_string(sid, _sample_eph(jgn))))
    jeph = asm.ephemeris()
    teph = tgn.GlonassEphemeris(**dataclasses.asdict(jeph))
    obs_epoch = [types.SimpleNamespace(
        prn=p, signal="1G", pseudorange_m=2.1e7 + 1e3 * p,
        carrier_phase_cycles=1.1e8 + p, doppler_hz=-1234.5 + p,
        cn0_dbhz=45.0) for p in (5, 10)]
    slots = trx.ReceiverConfig().glonass_freq_slots
    for tag, mod, eph in (("jax", jrinex, jeph), ("port", trinex, teph)):
        w = mod.RinexNavWriter(tmp_path / f"{tag}.nav")
        w.write_ephemeris(eph, system="R",
                          glonass_date=datetime.date(2024, 5, 6))
        w.write_ephemeris(eph, system="R")        # a repeat is skipped
        w.close()
        obs = mod.RinexObsWriter(
            tmp_path / f"{tag}.obs", ["1G", "2G"],
            approx_pos=(4.8e6, 1.6e5, 4.1e6),
            glo_slots={p: slots[p - 1] for p in (5, 10)})
        obs.write_epoch(2345, 352812.5, obs_epoch)
        obs.close()
        with pytest.raises(ValueError):
            mod.RinexNavWriter(tmp_path / f"{tag}2.nav",
                               version="2.11").write_ephemeris(eph)
    for ext in ("nav", "obs"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    text = (tmp_path / "port.obs").read_text()
    assert "GLONASS SLOT / FRQ #" in text
    assert "R    8 C1C L1C D1C S1C C2C L2C D2C S2C" in text
    got = trinex.RinexNavReader(tmp_path / "port.nav").read()
    want = jrinex.RinexNavReader(tmp_path / "jax.nav").read()
    assert list(got) == list(want) == [("R", 5)]
    assert dataclasses.asdict(got[("R", 5)]) == \
        dataclasses.asdict(want[("R", 5)])


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("name,sig,n_ch,fs", [
    ("glonass_l1", "1G", 6, 9.0e6), ("glonass_l2", "2G", 5, 6.0e6)])
def test_glonass_conf_binds_and_builds(name, sig, n_ch, fs):
    conf = ROOT / "conf" / f"{name}.conf"
    want = jini.receiver_config_from_ini(jini.FileConfiguration(conf))
    tconf = tini.FileConfiguration(conf)
    got = tini.receiver_config_from_ini(tconf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.signal, got.n_channels, got.fs) == (sig, n_ch, fs)
    g, = trx.Receiver(got, device="cpu").groups
    assert g.code_tables.shape == (n_ch, 511)
    step = jconst.SIGNALS[sig].fdma_step_hz
    for prn in (1, 10, 24):
        k = got.glonass_freq_slots[prn - 1]
        assert g.if_freq_for(prn) == k * step
        assert g.carrier_freq_for(prn) == \
            constants.glonass_carrier_hz(g.spec, k)
