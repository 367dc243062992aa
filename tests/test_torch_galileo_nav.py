"""The port's Galileo E1 host modules against the JAX package's, on the CPU:
the E1-B / E1-C memory codes and the CS25 secondary code
(gnss_sdr_tpu_torch.models.codes, from the port's own copy of the ICD hex
dumps), the BOC(1,1)-sampled replica, the K=7 r=1/2 convolutional code,
Viterbi decoder and block interleaver (models/nav/fec.py), the I/NAV page
codec and word assembler (models/nav/galileo_inav.py), the E1-B telemetry
decoder (receiver/telemetry.py) and the Galileo RINEX navigation records
(receiver/pvt/rinex.py).

Codes, FEC outputs, decoded words and ephemerides are compared exactly; the
I/NAV streams come from JAX's encoder, and the noise is made with numpy
from a seed, so both packages decode the same soft symbols. The RINEX
header's creation date is frozen in both modules (no line is masked).
"""

import dataclasses
import datetime
import types

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.models import codes as jcodes
from gnss_sdr_tpu.models.ephemeris import KeplerEphemeris as JEph
from gnss_sdr_tpu.models.nav import fec as jfec
from gnss_sdr_tpu.models.nav import galileo_inav as jinav
from gnss_sdr_tpu.receiver import telemetry as jtlm
from gnss_sdr_tpu.receiver.pvt import rinex as jrinex
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.models import codes as tcodes
from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris
from gnss_sdr_tpu_torch.models.nav import fec as tfec
from gnss_sdr_tpu_torch.models.nav import galileo_inav as tinav
from gnss_sdr_tpu_torch.receiver import telemetry as ttlm
from gnss_sdr_tpu_torch.receiver.pvt import rinex as trinex
from gnss_sdr_tpu_torch.utils import constellation

torch.set_num_threads(1)   # one thread per xdist worker

TOW0 = 345600.0


def _eph(prn: int) -> KeplerEphemeris:
    """A Galileo ephemeris of the almanac constellation with clock terms."""
    e = constellation.almanac_constellation()[prn]
    e.gm = constants.GM_EARTH_GAL
    e.af0, e.af1, e.tgd = 2.5e-5, -1.7e-12, 3.2e-9
    e.iode = 41 + prn
    return e


def _jeph(e: KeplerEphemeris) -> JEph:
    return JEph(**dataclasses.asdict(e))


def test_e1_codes_equal_jax():
    for prn in range(1, 51):
        np.testing.assert_array_equal(tcodes.code_chips("1B", prn),
                                      jcodes.code_chips("1B", prn))
        np.testing.assert_array_equal(tcodes.pilot_code_chips("1B", prn),
                                      jcodes.pilot_code_chips("1B", prn))
    np.testing.assert_array_equal(tcodes.pilot_secondary_chips("1B", 7),
                                  jcodes.pilot_secondary_chips("1B", 7))
    assert tcodes.has_pilot("1B") and not tcodes.has_pilot("1C")
    assert tcodes.pilot_secondary_chips("1C", 7) is None
    # the BOC(1,1) replica at 4 MSps (acquisition's 4 ms and 8 ms windows)
    for prn, phase in ((1, 0.0), (19, 0.37), (50, 1021.5)):
        for n in (16000, 32000):
            np.testing.assert_array_equal(
                tcodes.sample_code(tcodes.code_chips("1B", prn), 4.0e6,
                                   1.023e6, n, chip_phase=phase,
                                   boc_rate=1.023e6),
                jcodes.sample_code(jcodes.code_chips("1B", prn), 4.0e6,
                                   1.023e6, n, chip_phase=phase,
                                   boc_rate=1.023e6))
    np.testing.assert_array_equal(tcodes.code_chips("1G", 1),
                                  jcodes.code_chips("1G", 1))
    for mod in (tcodes, jcodes):
        with pytest.raises(ValueError, match="unknown signal"):
            mod.code_chips("XX", 1)


def test_fec_equal_jax():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 120).astype(np.int8)
    for inv in (False, True):
        sym = tfec.conv_encode(bits, invert_g2=inv)
        np.testing.assert_array_equal(sym, jfec.conv_encode(bits,
                                                            invert_g2=inv))
        soft = (2.0 * sym - 1.0) + 0.8 * rng.standard_normal(len(sym))
        got = tfec.viterbi_decode(soft, len(bits), invert_g2=inv)
        np.testing.assert_array_equal(
            got, jfec.viterbi_decode(soft, len(bits), invert_g2=inv))
        np.testing.assert_array_equal(
            tfec.viterbi_decode(2.0 * sym - 1.0, len(bits), invert_g2=inv),
            bits)
    x = rng.standard_normal(240)
    inter = tfec.block_interleave(x, 30, 8)
    np.testing.assert_array_equal(inter, jfec.block_interleave(x, 30, 8))
    np.testing.assert_array_equal(tfec.block_deinterleave(inter, 30, 8), x)
    np.testing.assert_array_equal(tfec.block_deinterleave(x, 30, 8),
                                  jfec.block_deinterleave(x, 30, 8))
    assert tfec.crc24q_bits(bits) == jfec.crc24q_bits(bits)


def _pages(symbols: np.ndarray) -> list:
    return [symbols[i: i + 500] for i in range(0, len(symbols) - 499, 500)]


def test_inav_pages_and_assembler_equal_jax():
    e = _eph(11)
    stream = jinav.encode_stream(_jeph(e), TOW0, 12)
    np.testing.assert_array_equal(tinav.encode_stream(e, TOW0, 12), stream)
    rng = np.random.default_rng(9)
    # soft symbols, + == bit 1, at an SNR where the Viterbi decoder earns
    # its keep
    soft = (2.0 * stream - 1.0) + 0.5 * rng.standard_normal(len(stream))
    t_asm, j_asm = tinav.InavAssembler(11), jinav.InavAssembler(11)
    types_seen = []
    for k, page in enumerate(_pages(soft)):
        got, want = tinav.decode_page(page), jinav.decode_page(page)
        assert (got is None) == (want is None), k
        if got is None:
            continue
        assert got[0] == want[0] and got[1] == want[1], k
        types_seen.append(got[0])
        t_asm.push(tinav.InavPage(got[0], got[1], 500 * k))
        j_asm.push(jinav.InavPage(want[0], want[1], 500 * k))
    assert {1, 2, 3, 4, 5} <= set(types_seen)
    te, je = t_asm.ephemeris(), j_asm.ephemeris()
    assert te is not None and je is not None
    assert dataclasses.asdict(te) == dataclasses.asdict(je)
    assert abs(te.sqrt_a - e.sqrt_a) <= 2.0 ** -19 and te.toe == e.toe
    assert te.gm == constants.GM_EARTH_GAL
    # a corrupted page fails its CRC in both
    bad = _pages(2.0 * stream - 1.0)[0].copy()
    bad[10:40] *= -1.0
    assert tinav.decode_page(bad) is None and jinav.decode_page(bad) is None


def test_e1b_telemetry_equal_jax():
    """The same prompt stream (I/NAV symbols from JAX's encoder, one per
    4 ms epoch, with noise and an epoch offset) through both decoders, in
    uneven blocks: the same page sync, TOW anchor, transmit times and
    ephemeris."""
    e = _eph(19)
    stream = jinav.encode_stream(_jeph(e), TOW0, 14).astype(np.float64)
    rng = np.random.default_rng(13)
    lead = 137                         # epochs before the first page start
    sym = np.concatenate([rng.integers(0, 2, lead), stream])
    prompts = (1.0 - 2.0 * sym) * 900.0 + 250.0 * rng.standard_normal(len(sym))
    epochs = np.arange(len(sym), dtype=np.int64) + 4000
    t, j = ttlm.make_telemetry("1B", 19), jtlm.make_telemetry("1B", 19)
    assert isinstance(t, ttlm.GalileoE1BTelemetry)
    pos = 0
    for n in (25, 700, 1, 2000, 333, 10 ** 6):
        for dec in (t, j):
            dec.push(epochs[pos: pos + n], prompts[pos: pos + n])
        pos += n
    assert t.page_phase == j.page_phase == (4000 + lead) % 500
    assert t.page_count == j.page_count > 10
    assert t.have_tow and dataclasses.asdict(t.tow_ref) == \
        dataclasses.asdict(j.tow_ref)
    for ep, chips in ((4137, 0.0), (5000, 1234.5), (9000, 4091.9)):
        assert t.transmit_time(ep, chips) == j.transmit_time(ep, chips)
    assert dataclasses.asdict(t.ephemeris()) == \
        dataclasses.asdict(j.ephemeris())


class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 6, 7, 8, 9, tzinfo=tz)


def test_galileo_rinex_nav_byte_identical(tmp_path, monkeypatch):
    fake = types.SimpleNamespace(datetime=_Frozen, date=datetime.date,
                                 timezone=datetime.timezone,
                                 timedelta=datetime.timedelta)
    monkeypatch.setattr(jrinex, "datetime", fake)
    monkeypatch.setattr(trinex, "datetime", fake)
    port = {("G", 3): constellation.almanac_constellation()[3]}
    port.update({("E", p): _eph(p) for p in (5, 17, 24)})
    for tag, mod, conv in (("jax", jrinex, _jeph), ("port", trinex,
                                                     lambda x: x)):
        w = mod.RinexNavWriter(tmp_path / f"{tag}.nav")
        for (system, _), eph in port.items():
            w.write_ephemeris(conv(eph), system=system)
        w.close()
        obs = mod.RinexObsWriter(tmp_path / f"{tag}.obs", ["1C", "1B"],
                                 approx_pos=(4.8e6, 1.6e5, 4.1e6))
        obs.close()
    for ext in ("nav", "obs"):
        assert ((tmp_path / f"port.{ext}").read_bytes()
                == (tmp_path / f"jax.{ext}").read_bytes()), ext
    back = trinex.RinexNavReader(tmp_path / "port.nav").read()
    assert sorted(back) == sorted(port)
    assert back[("E", 17)].gm == constants.GM_EARTH_GAL
    assert back[("E", 17)].toe == port[("E", 17)].toe
    with pytest.raises(ValueError):
        trinex.RinexNavWriter(tmp_path / "v2.nav", version="2.11"
                              ).write_ephemeris(port[("E", 5)], system="E")
