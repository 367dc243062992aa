"""The port's GPS L5 and Galileo E5a host modules and acquisition against
the JAX package's, on the CPU:

- the CNAV codec (models/nav/gps_cnav.py: messages 10 / 11 / 30, the
  continuous K=7 symbol stream, the decoder and the assembler) and the F/NAV
  codec (models/nav/galileo_fnav.py: page types 1-4, the interleaved page
  stream, the decoder and the assembler): bits, symbols and decoded fields
  are equal;
- ``GpsL5ITelemetry`` (NH10 symbol sync, 100 sps CNAV) and
  ``GalileoE5aTelemetry`` (CS20 symbol sync, 500-symbol F/NAV pages) on the
  prompt streams of tests/test_telemetry_channels.py (same seeds, noise,
  start offsets and polarity): the same symbol phase, TOW anchor, transmit
  times and ephemeris;
- the RINEX records of CNAV / F/NAV ephemerides and of ``5I`` observations,
  byte for byte;
- acquisition: ``caf_triangular_smooth``, ``noncoherent_iq_caf_search`` on
  the inputs of tests/test_acq_variants.py:241 and PCPS at L5 on the inputs
  of tests/test_acquisition.py:185-205 give the same cell (code phase,
  Doppler bin) as JAX's, with every statistic within 1e-4 relative.
"""

import dataclasses
import datetime
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu import constants as jconst
from gnss_sdr_tpu.models.nav import galileo_fnav as jfnav
from gnss_sdr_tpu.models.nav import gps_cnav as jcnav
from gnss_sdr_tpu.ops import acquisition as jacq
from gnss_sdr_tpu.ops import iq as jiq
from gnss_sdr_tpu.receiver import telemetry as jtlm
from gnss_sdr_tpu.receiver.pvt import rinex as jrinex
from gnss_sdr_tpu.utils import generator as jgen
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.models import codes as tcodes
from gnss_sdr_tpu_torch.models.ephemeris import IonoParams, KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import galileo_fnav as tfnav
from gnss_sdr_tpu_torch.models.nav import gps_cnav as tcnav
from gnss_sdr_tpu_torch.ops import acquisition as tacq
from gnss_sdr_tpu_torch.receiver import telemetry as ttlm
from gnss_sdr_tpu_torch.receiver.pvt import rinex as trinex

from test_lnav import sample_ephemeris

torch.set_num_threads(1)   # one thread per xdist worker


def _port(eph) -> KeplerEphemeris:
    return KeplerEphemeris(**dataclasses.asdict(eph))


def _feed(tlm, prompts, chunk=137, epoch0=0):
    """tests/test_telemetry_channels.py's feeder."""
    e = epoch0 + np.arange(len(prompts), dtype=np.int64)
    for i in range(0, len(prompts), chunk):
        tlm.push(e[i:i + chunk], prompts[i:i + chunk])


def _same_decoder_state(t, j, epochs):
    assert t.bit_phase == j.bit_phase is not None
    assert t.have_tow and dataclasses.asdict(t.tow_ref) == \
        dataclasses.asdict(j.tow_ref)
    for ep in epochs:
        for chips in (0.0, 5115.5, 10229.9):
            assert t.transmit_time(ep, chips) == j.transmit_time(ep, chips)
    assert dataclasses.asdict(t.ephemeris()) == \
        dataclasses.asdict(j.ephemeris())
    assert t.sync_failed == j.sync_failed is False


# ------------------------------------------------------------------ CNAV
def test_cnav_messages_and_stream_equal_jax():
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    iono = jcnav.IonoParams(alpha=(1.1e-8, 2.2e-8, -5.9e-8, -1.2e-7),
                            beta=(9.0e4, 1.1e5, -6.5e4, -5.2e5), valid=True)
    tiono = IonoParams(**dataclasses.asdict(iono))
    for mtype in (10, 11, 30):
        a = jcnav.encode_message(mtype, 9, 352806.0, eph, iono=iono)
        b = tcnav.encode_message(mtype, 9, 352806.0, _port(eph), iono=tiono)
        np.testing.assert_array_equal(b, a, err_msg=f"MT{mtype}")
        ja, ta = jcnav.decode_message(a), tcnav.decode_message(b)
        assert ta is not None and ta[:3] == ja[:3]
        assert ta[3].keys() == ja[3].keys()
        for k, v in ja[3].items():
            w = ta[3][k]
            assert (dataclasses.asdict(w) == dataclasses.asdict(v)
                    if dataclasses.is_dataclass(v) else w == v), k
    js = jcnav.encode_symbol_stream(eph, 352800.0, 6, iono=iono, period_s=6.0)
    ts = tcnav.encode_symbol_stream(_port(eph), 352800.0, 6, iono=tiono,
                                    period_s=6.0)
    np.testing.assert_array_equal(ts, js)
    # a corrupted message fails the CRC in both
    bad = jcnav.encode_message(10, 9, 352806.0, eph).copy()
    bad[100] ^= 1
    assert tcnav.decode_message(bad) is None and jcnav.decode_message(bad) is None


def test_l5_telemetry_equal_jax():
    """tests/test_telemetry_channels.py::test_gps_l5_cnav_telemetry's
    stream (NH10 overlay, 10 epochs per symbol, noise seed 11, start 337,
    polarity flipped) through both decoders."""
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    sym = jcnav.encode_symbol_stream(eph, 352800.0, 6, period_s=6.0)
    nh = np.array([int(b) for b in jconst.GPS_L5_I.secondary_code],
                  np.float64)
    sym_amp = 100.0 * (1.0 - 2.0 * sym.astype(np.float64))
    prompts = (np.repeat(sym_amp, 10).reshape(-1, 10)
               * (1.0 - 2.0 * nh)[None, :]).reshape(-1)
    rng = np.random.default_rng(11)
    prompts = prompts + rng.normal(0, 22.0, len(prompts))
    start = 337
    t, j = ttlm.make_telemetry("L5", 9), jtlm.make_telemetry("L5", 9)
    assert isinstance(t, ttlm.GpsL5ITelemetry)
    # the port's decoder in the JAX test's blocks of 137 epochs, its frame
    # search resuming across pushes; JAX's in blocks of 8000: until it
    # finds the frame it repeats its Viterbi search on every push (~100 s
    # in blocks of 137)
    _feed(t, -prompts[start:], chunk=137, epoch0=91)
    _feed(j, -prompts[start:], chunk=8000, epoch0=91)
    assert t.message_count == j.message_count >= 3
    assert t.half_cycle == j.half_cycle == 0.5
    _same_decoder_state(t, j, (91, 191, 5000, 20000))


# ----------------------------------------------------------------- F/NAV
def test_fnav_pages_and_stream_equal_jax():
    eph = sample_ephemeris()
    eph.toe = 352800.0
    eph.gm = constants.GM_EARTH_GAL
    for ptype in (1, 2, 3, 4):
        a = jfnav.encode_page_bits(ptype, eph, wn=eph.week, tow=352810.0)
        b = tfnav.encode_page_bits(ptype, _port(eph), wn=eph.week,
                                   tow=352810.0)
        np.testing.assert_array_equal(b, a, err_msg=f"page {ptype}")
        ja, ta = jfnav.decode_page_bits(a), tfnav.decode_page_bits(b)
        assert ta == ja
        sa, sb = jfnav.encode_page(a), tfnav.encode_page(b)
        np.testing.assert_array_equal(sb, sa)
        soft = 1.0 - 2.0 * sb.astype(np.float64)
        assert tfnav.decode_page(soft) == jfnav.decode_page(soft) is not None
    js = jfnav.encode_stream(eph, 352800.0, 6, wn=eph.week, page_offset=3)
    ts = tfnav.encode_stream(_port(eph), 352800.0, 6, wn=eph.week,
                             page_offset=3)
    np.testing.assert_array_equal(ts, js)


def test_e5a_telemetry_equal_jax():
    """tests/test_telemetry_channels.py::test_galileo_e5a_fnav_telemetry's
    stream (CS20 overlay, 20 epochs per symbol, noise seed 11, start 777)
    through both decoders."""
    eph = sample_ephemeris()
    eph.toe = 352800.0
    tow0 = 352800.0
    sym01 = jfnav.encode_stream(eph, tow0, n_pages=6, wn=eph.week)
    cs = np.array([int(b) for b in jconst.GALILEO_E5A_I.secondary_code])
    sym_amp = 70.0 * (1.0 - 2.0 * sym01.astype(np.float64))
    prompts = (np.repeat(sym_amp, 20).reshape(-1, 20)
               * (1.0 - 2.0 * cs)[None, :]).reshape(-1)
    rng = np.random.default_rng(11)
    prompts = prompts + rng.normal(0, 15.0, len(prompts))
    start = 777
    t, j = ttlm.make_telemetry("5X", eph.prn), jtlm.make_telemetry("5X", eph.prn)
    assert isinstance(t, ttlm.GalileoE5aTelemetry)
    for dec in (t, j):
        _feed(dec, prompts[start:], epoch0=123)
    assert t.page_count == j.page_count >= 4
    assert t.page_phase == j.page_phase
    _same_decoder_state(t, j, (123, 1000, 30000))


def _e5a_stream():
    """test_e5a_telemetry_equal_jax's stream: (prompts, epoch0)."""
    eph = sample_ephemeris()
    eph.toe = 352800.0
    sym01 = jfnav.encode_stream(eph, 352800.0, n_pages=6, wn=eph.week)
    cs = np.array([int(b) for b in jconst.GALILEO_E5A_I.secondary_code])
    prompts = (np.repeat(70.0 * (1.0 - 2.0 * sym01.astype(np.float64)), 20)
               .reshape(-1, 20) * (1.0 - 2.0 * cs)[None, :]).reshape(-1)
    prompts = prompts + np.random.default_rng(11).normal(0, 15.0,
                                                          len(prompts))
    return prompts[777:], 123


def test_fnav_page_search_resumes_across_pushes():
    """Fed in 137-epoch blocks (a chunk's worth, the JAX test's feeder),
    the port's F/NAV decoder finds the page at the offset one push of the
    whole stream finds, and decodes the same pages there: its search
    resumes at the first offset not yet tried instead of starting again on
    every push (15.4 s of a 47 s E5a run's wall on an H100 before). The
    CNAV frame search resumes the same way; test_l5_telemetry_equal_jax
    feeds it in blocks of 137."""
    prompts, epoch0 = _e5a_stream()
    small, whole = (ttlm.make_telemetry("5X", 9) for _ in range(2))
    _feed(small, prompts, chunk=137, epoch0=epoch0)
    _feed(whole, prompts, chunk=len(prompts), epoch0=epoch0)
    for dec in (small, whole):
        assert dec._hist.n == len(prompts)
        np.testing.assert_array_equal(dec._hist.prompts, prompts)
    assert small.page_count == whole.page_count >= 3
    assert small.page_phase == whole.page_phase is not None
    assert small._decoded_upto == whole._decoded_upto
    assert small._search_from <= whole._decoded_upto
    assert dataclasses.asdict(small.tow_ref) == dataclasses.asdict(
        whole.tow_ref)
    assert dataclasses.asdict(small.ephemeris()) == dataclasses.asdict(
        whole.ephemeris())


def test_overlay_sync_waits_and_watchdog():
    """Too few prompts: no symbol phase yet in either package; a stream of
    pure noise past 6 s trips the sync watchdog in both."""
    rng = np.random.default_rng(5)
    noise = rng.normal(0, 10.0, 6500)
    for sig in ("L5", "5X"):
        t, j = ttlm.make_telemetry(sig, 3), jtlm.make_telemetry(sig, 3)
        for dec in (t, j):
            _feed(dec, noise[:250])
        assert t.bit_phase is None and j.bit_phase is None
        for dec in (t, j):
            _feed(dec, noise[250:], epoch0=250)
        assert t.sync_failed == j.sync_failed


# ----------------------------------------------------------------- RINEX
class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 6, 7, 8, 9, tzinfo=tz)


def test_wideband_rinex_byte_identical(tmp_path, monkeypatch):
    """CNAV ephemerides as GPS records, F/NAV ones as Galileo records (with
    the data-source word JAX writes), and an observation header of L5 + E5a
    (both ``5I``)."""
    fake = types.SimpleNamespace(datetime=_Frozen, date=datetime.date,
                                 timezone=datetime.timezone,
                                 timedelta=datetime.timedelta)
    monkeypatch.setattr(jrinex, "datetime", fake)
    monkeypatch.setattr(trinex, "datetime", fake)
    eph = sample_ephemeris()
    eph.toe = eph.toc = 352800.0
    iono = jcnav.IonoParams(alpha=(0.0,) * 4, beta=(0.0,) * 4, valid=False)
    cn = jcnav.CnavAssembler(9)
    for mtype in (10, 11, 30):
        res = jcnav.decode_message(
            jcnav.encode_message(mtype, 9, 352806.0, eph, iono=iono))
        cn.push(res[0], res[3])
    gal = sample_ephemeris()
    gal.toe = 352800.0
    gal.gm = constants.GM_EARTH_GAL
    fn = jfnav.FnavAssembler(gal.prn)
    for ptype in (1, 2, 3, 4):
        fn.push(*jfnav.decode_page_bits(jfnav.encode_page_bits(
            ptype, gal, wn=gal.week, tow=352800.0 + 10 * ptype)))
    records = [("G", cn.ephemeris()), ("E", fn.ephemeris())]
    assert all(e is not None for _, e in records)
    obs_epoch = [types.SimpleNamespace(
        prn=p, signal=sig, pseudorange_m=2.1e7 + 1e3 * p,
        carrier_phase_cycles=1.1e8 + p, doppler_hz=-1234.5 + p, cn0_dbhz=47.0)
        for p, sig in ((9, "L5"), (11, "5X"))]
    for tag, mod, conv in (("jax", jrinex, lambda x: x),
                           ("port", trinex, _port)):
        w = mod.RinexNavWriter(tmp_path / f"{tag}.nav")
        for system, e in records:
            w.write_ephemeris(conv(e), system=system)
        w.close()
        obs = mod.RinexObsWriter(tmp_path / f"{tag}.obs", ["L5", "5X"],
                                 approx_pos=(4.8e6, 1.6e5, 4.1e6))
        obs.write_epoch(2345, 352812.5, obs_epoch)
        obs.close()
    for ext in ("nav", "obs"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    assert "C5I" in (tmp_path / "port.obs").read_text()


# ------------------------------------------------------------ acquisition
def _same_result(t, j):
    np.testing.assert_array_equal(t.code_phase.numpy(), np.asarray(j.code_phase))
    np.testing.assert_array_equal(t.doppler_hz.numpy(), np.asarray(j.doppler_hz))
    for f in ("test_cfar", "test_max_power", "magnitude"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-4,
                                   err_msg=f)


def test_caf_triangular_smooth_equal_jax():
    rng = np.random.default_rng(2)
    v = rng.random((3, 41)).astype(np.float32)
    for h in (0, 1, 6, 12, 40):
        np.testing.assert_allclose(
            tacq.caf_triangular_smooth(torch.from_numpy(v), h).numpy(),
            np.asarray(jacq.caf_triangular_smooth(jnp.asarray(v), h)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("both", [True, False], ids=["iq", "data_only"])
def test_noncoherent_iq_caf_search_equal_jax(both):
    """tests/test_acq_variants.py:241's input (E5a PRN 2 at 46 dB-Hz with
    its pilot, -2200 Hz, 6 ms at 12 MSps, seed 5), CAF window of 6 bins,
    two noncoherent dwells, and a second candidate that is absent."""
    spec = jconst.SIGNALS["5X"]
    fs = 12.0e6
    prn, fd_true, delay_s = 2, -2200.0, 0.00013
    x = jgen.generate(
        spec, [jgen.SatParams(prn=prn, cn0_dbhz=46.0, doppler_hz=fd_true,
                              code_delay_s=delay_s)],
        fs, 0.006, seed=5, with_pilot=True)
    spc = int(round(fs * spec.code_period_s))

    def spectra(p):
        out = []
        for chips in (tcodes.code_chips("5X", p),
                      tcodes.pilot_code_chips("5X", p)):
            rep = tcodes.sample_code(chips, fs, spec.code_rate_cps, spc)
            out.append(jiq.split(np.conj(np.fft.fft(rep))))
        return out
    cfd, cfp = (np.stack(c) for c in zip(spectra(prn), spectra(9)))
    dop = jacq.make_doppler_grid(4000, 250)
    spchip = max(1, int(fs / spec.code_rate_cps))
    xs = jiq.split(x[: 2 * spc])
    kw = dict(fs=fs, samples_per_code=spc, samples_per_chip=spchip,
              noncoherent=2, caf_bins_half=6, both_components=both)
    j = jacq.noncoherent_iq_caf_search(xs, cfd, cfp, jnp.asarray(dop), **kw)
    t = tacq.noncoherent_iq_caf_search(
        torch.from_numpy(xs), torch.from_numpy(cfd), torch.from_numpy(cfp),
        torch.from_numpy(dop), **kw)
    _same_result(t, j)
    assert abs(float(t.doppler_hz[0]) - fd_true) <= 250.0


def test_pcps_l5_equal_jax():
    """tests/test_acquisition.py:185-205's input (L5 PRN 7 at 50 dB-Hz with
    a random symbol per epoch on top of NH10, 11 MSps, seed 9) in the
    doubled-FFT mode, at the four dwell starts of that test."""
    from gnss_sdr_tpu.models import codes as jcodes
    spec = jconst.SIGNALS["L5"]
    fs, spc = 11.0e6, 11000
    prn, fd_true = 7, 2300.0
    rng = np.random.default_rng(3)
    bits = np.sign(rng.standard_normal(4000))
    x = jgen.generate(
        spec, [jgen.SatParams(prn=prn, cn0_dbhz=50.0, doppler_hz=fd_true,
                              code_delay_s=2.34e-4, data_bits=bits)],
        fs, 0.05, seed=9)
    rep = jcodes.sample_code(jcodes.code_chips("L5", prn).astype(np.float64),
                             fs, 10.23e6, spc)
    rep2 = np.concatenate([rep, np.zeros_like(rep)])
    cf2 = jiq.split(np.conj(np.fft.fft(rep2)))[None]
    dop = jacq.make_doppler_grid(5000.0, 125.0)
    for start in (0, 3000, 7000, 12000):
        seg = jiq.split(np.ascontiguousarray(x[start: start + 4 * spc]))
        kw = dict(fs=fs, samples_per_code=spc, samples_per_chip=1,
                  noncoherent=2)
        j = jacq.pcps_search(seg, cf2, dop, **kw)
        t = tacq.pcps_search(torch.from_numpy(seg), torch.from_numpy(cf2),
                             torch.from_numpy(dop), **kw)
        _same_result(t, j)
        assert abs(float(t.doppler_hz[0]) - fd_true) <= 125.0
