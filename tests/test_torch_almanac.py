"""The port's almanac pages against the JAX package: ``BeidouAlmanac`` and
the D1 almanac, health and almanac-reference pages (encode, decode,
assemble; tests/test_almanac.py's BeiDou cases), the B1I scenario's
``almanac_pages`` option, and the control plane's assistance checkpoint
with every almanac class and GLONASS ephemerides."""

import dataclasses

import numpy as np

from gnss_sdr_tpu import constants as jC
from gnss_sdr_tpu.models import almanac as jalm
from gnss_sdr_tpu.models.ephemeris import KeplerEphemeris as JEph
from gnss_sdr_tpu.models.nav import beidou_d1 as jd1
from gnss_sdr_tpu.models.nav import glonass_gnav as jgnav
from gnss_sdr_tpu.receiver import control as jctl
from gnss_sdr_tpu_torch import constants as tC
from gnss_sdr_tpu_torch.models import almanac as talm
from gnss_sdr_tpu_torch.models.ephemeris import KeplerEphemeris as TEph
from gnss_sdr_tpu_torch.models.nav import beidou_d1 as td1
from gnss_sdr_tpu_torch.receiver import control as tctl
from gnss_sdr_tpu_torch.utils import scenario as tscen

# (SV, GEO, subframe, page): MEO SV 8 on SF4 page 8, GEO SV 1 on SF4 page
# 1, SV 27 on SF5 page 3 (tests/test_almanac.py)
CASES = [(8, False, 4, 8), (1, True, 4, 1), (27, False, 5, 3)]


def _bds_eph(cls, consts, almanac_mod, rng, prn, geo):
    return cls(prn=prn, week=310, toe=352800.0, toc=352800.0,
               sqrt_a=np.sqrt(42.16e6 if geo else 27.9e6),
               e=0.001 + 0.002 * rng.random(),
               m0=rng.uniform(-np.pi, np.pi),
               omega0=rng.uniform(-np.pi, np.pi),
               omega_dot=(-2e-9 if geo else -7e-9),
               omega=rng.uniform(-np.pi, np.pi),
               i0=(0.01 if geo else almanac_mod.BDS_ALMANAC_I0_REF + 0.02),
               af0=rng.normal(0, 1e-4), af1=rng.normal(0, 1e-11),
               gm=consts.GM_EARTH_BDS)


def _assemble(d1, alm_mod, eph_cls, consts, healths):
    """Both packages' steps: almanacs from ephemerides, their pages, the
    health and reference pages, through the decoder into one assembler."""
    rng = np.random.default_rng(11)
    asm = d1.D1Assembler(prn=6)
    words = []
    ephs = {}
    for sv, geo, fraid, pnum in CASES:
        eph = _bds_eph(eph_cls, consts, alm_mod, rng, sv, geo)
        ephs[sv] = eph
        alm = alm_mod.BeidouAlmanac.from_ephemeris(eph)
        words.append(d1.encode_almanac_page(fraid, 352806.0, alm, pnum))
    words.append(d1.encode_health_page(352812.0, healths))
    words.append(d1.encode_almanac_reference_page(
        352818.0, 352800.0, wna=310 & 0xFF, healths=healths))
    for w in words:
        out = d1.decode_subframe(w)
        assert out is not None
        asm.push(out[0], out[2])
    return asm, words, ephs


def test_beidou_almanac_health_and_reference_pages_equal_jax():
    healths = {8: 0x100, 27: 3, 1: 0}
    t, twords, tephs = _assemble(td1, talm, TEph, tC, healths)
    j, jwords, _ = _assemble(jd1, jalm, JEph, jC, healths)
    for a, b in zip(twords, jwords):
        assert np.array_equal(a, b)
    assert sorted(t.almanacs) == sorted(j.almanacs) == [1, 8, 27]
    for sv in t.almanacs:
        assert dataclasses.asdict(t.almanacs[sv]) == \
            dataclasses.asdict(j.almanacs[sv])
    assert t.health == j.health and t.health[8] == 0x100
    assert (t.alm_wna, t.alm_toa) == (j.alm_wna, j.alm_toa)
    # tests/test_almanac.py's budget: each decoded orbit within 5 km of
    # the ephemeris it projects
    for sv, a in t.almanacs.items():
        assert a.wna == 310 & 0xFF and a.health == healths.get(sv, 0)
        for dt in (0.0, 7200.0):
            p1, _ = tephs[sv].position_velocity(a.toa + dt)
            p2, _ = a.position_velocity(a.toa + dt)
            assert np.linalg.norm(p1 - p2) < 5_000.0, (sv, dt)
    # an empty page (sqrt_a = 0) makes no record, in either package
    for d1 in (td1, jd1):
        asm = d1.D1Assembler(prn=6)
        out = d1.decode_subframe(d1.encode_almanac_reference_page(
            352812.0, 352800.0, wna=0))
        asm.push(out[0], out[2])
        assert asm.almanacs == {}


def test_b1i_scenario_almanac_pages_equal_jax():
    """build_beidou_b1i_scenario(almanac_pages=True): the same D1 symbols
    as JAX's, whose pages rebuild the visible satellites' almanacs."""
    from gnss_sdr_tpu.utils import scenario as jscen

    t = tscen.build_beidou_b1i_scenario(duration_s=150.0, n_sats=4,
                                        almanac_pages=True)
    j = jscen.build_beidou_b1i_scenario(duration_s=150.0, n_sats=4,
                                        almanac_pages=True)
    assert t.prns == j.prns
    for a, b in zip(t.sats, j.sats):
        assert np.array_equal(a.data_bits, b.data_bits)
    bits = ((1.0 - t.sats[0].data_bits) / 2.0).astype(np.uint8)
    asm = td1.D1Assembler(prn=t.prns[0])
    for k in range(len(bits) // 300):
        out = td1.decode_subframe(bits[k * 300:(k + 1) * 300])
        assert out is not None, k
        asm.push(out[0], out[2])
    assert asm.ephemeris() is not None
    assert set(t.prns) <= set(asm.almanacs)
    assert all(a.wna == asm.alm_wna for a in asm.almanacs.values())


def test_assistance_restores_every_almanac_and_glonass(tmp_path):
    """A checkpoint JAX writes with GLONASS ephemerides and GPS, Galileo,
    GLONASS and BeiDou almanacs loads in the port to the same records."""
    geph = jgnav.GlonassEphemeris(slot=3, freq_slot=5, tb_s=45900.0,
                                  pos_m=(1.2e7, -1.1e7, 1.9e7),
                                  vel_m_s=(1.5e3, 2.2e3, -0.3e3),
                                  acc_m_s2=(1e-6, -2e-6, 3e-6),
                                  gamma_n=1e-12, tau_n=-2e-5)
    eph = JEph(prn=7, week=2300, toe=352800.0, toc=352800.0,
               sqrt_a=5153.6, e=0.01, i0=0.96)
    alms = {("G", 7): jalm.GpsAlmanac.from_ephemeris(eph),
            ("E", 11): jalm.GalileoAlmanac(svid=11, delta_sqrt_a=0.5,
                                           e=0.001, toa=3600.0),
            ("R", 3): jalm.GlonassAlmanac(slot=3, freq_slot=5, health=1),
            ("C", 27): jalm.BeidouAlmanac(prn=27, sqrt_a=5282.0,
                                          toa=352256.0, health=3)}
    path = tmp_path / "assist.json"
    jctl.save_assistance(path, {("G", 7): eph, ("R", 3): geph},
                         almanacs=alms, tow_s=352810.0)
    t, j = tctl.load_assistance(path), jctl.load_assistance(path)
    assert sorted(t.ephemerides) == sorted(j.ephemerides)
    assert sorted(t.almanacs) == sorted(j.almanacs) == sorted(alms)
    for got_d, want_d in ((t.ephemerides, j.ephemerides),
                          (t.almanacs, j.almanacs)):
        for key, want in want_d.items():
            got = got_d[key]
            assert type(got).__name__ == type(want).__name__, key
            assert dataclasses.asdict(got) == dataclasses.asdict(want), key
    r = t.ephemerides[("R", 3)]
    np.testing.assert_array_equal(r.position_velocity(45960.0)[0],
                                  geph.position_velocity(45960.0)[0])
