"""Port SBAS L1 (gnss_sdr_tpu_torch.models.nav.sbas and the solver's SBAS
corrections) against the JAX package.

* The MOPS codec: every message type the port encodes (MT1 mask, MT2-5
  fast corrections, MT24 / MT25 long-term corrections, MT18 IGP mask, MT26
  grid delays, MT9 GEO navigation) round-trips through the framed,
  convolutionally coded stream, and the port's parsers give JAX's fields
  on the same bits.
* ``SbasIonoGrid``: vertical and slant delays equal JAX's on a sweep of
  positions and look angles (the same float64 arithmetic: exact).
* The solver with SBAS long-term corrections and the grid ionosphere
  (tests/test_sbas_corrections.py's case): the port's fix equals JAX's to
  float64 round-off.

The decoder, the scenario's SBAS channel and the receiver:
tests/test_torch_sbas_chain.py. Three tests a file, for the ``--dist
loadfile`` queueing that tests/test_torch_kalman.py's docstring gives
(pytest-xdist 3.8.0).
"""

import dataclasses

import numpy as np
import torch

from gnss_sdr_tpu.models.nav import sbas as jsbas
from gnss_sdr_tpu.receiver.pvt import solver as jsolver
from gnss_sdr_tpu.utils import constellation as jconst
from gnss_sdr_tpu_torch.models.nav import sbas as tsbas
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.receiver.pvt import solver as tsolver
from gnss_sdr_tpu_torch.utils import constellation as tconst

torch.set_num_threads(1)   # one thread per xdist worker

TRUE_LLH = (np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
T0 = 352800.0


def _messages(mod):
    """One message of every type the codec encodes, from module ``mod``
    (either package's sbas)."""
    rng = np.random.default_rng(5)
    mask = np.zeros(212, np.uint8)
    mask[[0, 4, 10, 22, 30]] = 1
    fast = rng.integers(0, 2, 212).astype(np.uint8)
    c1 = mod.LongTermCorrection(3, 17, (1.5, -2.25, 0.875), 2.5e-8)
    c2 = mod.LongTermCorrection(9, 211, (-0.5, 0.125, 3.0), -1.2e-8)
    cv = mod.LongTermCorrection(5, 9, (3.0, -1.125, 2.0), -1e-8,
                                dvel=(0.01, -0.02, 0.005), daf1=2e-12,
                                t0_s=40000.0)
    m25 = mod.encode_type25(mod.encode_type25_half(c1, c2),
                            mod.encode_type25_half(cv, velocity=True))
    m24 = np.concatenate([fast[:106], mod.encode_type25_half(c1, c2)])
    m18 = mod.encode_type18_igp_mask(4, [101, 102, 120, 121], iodi=2)
    m26 = mod.encode_type26_iono_delays(4, 0, [(2.5, 4), (3.5, 4),
                                               (4.125, 5), (1.0, 3)])
    geo = mod.SbasGeoEphemeris(prn=123, iodn=3, t0_s=43216.0, ura=4,
                               pos_m=(-3.1e7, 2.9e7, 1.2e5),
                               vel_m_s=(1.25, -0.5, 3.0),
                               acc_m_s2=(1e-4, -2e-4, 5e-5),
                               agf0_s=-3.5e-7, agf1_s_s=1.1e-11)
    m9 = mod.encode_type9_geo_nav(geo)
    return [(1, mask), (2, fast), (3, fast[::-1].copy()), (4, fast),
            (5, fast), (24, m24), (25, m25), (18, m18), (26, m26), (9, m9)]


def _fields(obj):
    """A LongTermCorrection's (a plain class) or a dataclass's fields."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.astuple(obj)
    return tuple(sorted(vars(obj).items()))


def _parsed(mod, mtype, data):
    """Every field the parsers of ``mod`` read from one message."""
    if mtype == 1:
        return mod.parse_type1_mask(data)
    if mtype in (2, 3, 4, 5):
        return mod.parse_fast_corrections(mtype, data)
    if mtype == 24:
        p = mod.parse_type24(data, tow_s=40100.0)
        return dict(p, long_term=[_fields(c) for c in p["long_term"]])
    if mtype == 25:
        return [_fields(c) for c in mod.parse_type25(data, tow_s=40100.0)]
    if mtype == 18:
        return mod.parse_type18_igp_mask(data)
    if mtype == 26:
        return mod.parse_type26_iono_delays(data)
    return dataclasses.astuple(mod.parse_type9_geo_nav(data, prn=123))


def _plain(v):
    """Nested lists / tuples / dicts / arrays as Python values."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_plain(x) for x in v]
    return v.item() if isinstance(v, np.generic) else v


def test_every_message_type_roundtrips_as_jax():
    tmsgs, jmsgs = _messages(tsbas), _messages(jsbas)
    for (tt, td), (jt, jd) in zip(tmsgs, jmsgs):
        assert tt == jt and np.array_equal(td, jd), tt
    # the FEC runs on across messages with no flush: a last (type 0)
    # message lets the decoder close the one before it
    tail = [(0, np.zeros(212, np.uint8))]
    sym = tsbas.encode_stream(tmsgs + tail)
    assert np.array_equal(sym, jsbas.encode_stream(jmsgs + tail))
    # the decoder's soft convention: +amplitude = bit 1
    soft = 2.0 * sym.astype(np.float64) - 1.0
    got = tsbas.decode_stream(soft)
    assert [m for _, m, _ in got][:len(tmsgs)] == [m for m, _ in tmsgs]
    for (off, mtype, data), (want_t, want_d) in zip(got, tmsgs):
        assert np.array_equal(data, want_d), mtype
        assert _plain(_parsed(tsbas, mtype, data)) == \
            _plain(_parsed(jsbas, mtype, data)), mtype
    jgot = jsbas.decode_stream(soft)
    assert [(o, m) for o, m, _ in got] == [(o, m) for o, m, _ in jgot]


def _grid(mod, bands=(3, 4, 5)):
    """The IGP bands ``bands`` masked whole, delays from a smooth field."""
    def viono(lat_deg, lon_deg):
        return 3.0 + 0.08 * (lat_deg - 40.0) + 0.05 * (lon_deg - 2.0)

    grid = mod.SbasIonoGrid()
    for band in bands:
        n = sum(len(lats) for _, lats in mod._BAND_COLUMNS[band])
        igps = list(range(1, n + 1))
        grid.update_mask(mod.parse_type18_igp_mask(
            mod.encode_type18_igp_mask(band, igps)))
        vals = [(viono(*mod.igp_location(band, i)), 5) for i in igps]
        for blk in range((len(vals) + 14) // 15):
            grid.update_delays(mod.parse_type26_iono_delays(
                mod.encode_type26_iono_delays(
                    band, blk, vals[15 * blk: 15 * blk + 15])))
    return grid


def test_iono_grid_slant_delay_equals_jax_on_a_sweep():
    tg, jg = _grid(tsbas), _grid(jsbas)
    assert tg.n_points == jg.n_points > 0
    n_some = 0
    for lat in np.deg2rad(np.linspace(30.0, 55.0, 7)):
        for lon in np.deg2rad(np.linspace(-12.0, 25.0, 7)):
            for az in np.deg2rad(np.arange(0.0, 360.0, 45.0)):
                for el in np.deg2rad((5.0, 15.0, 40.0, 89.0)):
                    t = tg.slant_delay(lat, lon, az, el)
                    assert t == jg.slant_delay(lat, lon, az, el)
                    n_some += t is not None
            v = tg.vertical_delay(np.degrees(lat), np.degrees(lon))
            assert v == jg.vertical_delay(np.degrees(lat), np.degrees(lon))
    assert n_some > 500
    for band in (0, 4, 8):
        for igp in (1, 28, 101, 178, 200):
            assert tsbas.igp_location(band, igp) == \
                jsbas.igp_location(band, igp)


def test_solver_with_sbas_corrections_equals_jax():
    """tests/test_sbas_corrections.py's degraded broadcast (clock errors +
    grid ionosphere) with the matching long-term corrections: the port's
    solve equals JAX's, and both meet that test's budget."""
    fixes = {}
    for tag, mod, cons, solv in (("port", tsbas, tconst, tsolver),
                                 ("jax", jsbas, jconst, jsolver)):
        ephs = cons.almanac_constellation()
        rcv = geodesy.geodetic_to_ecef(*TRUE_LLH)
        vis = cons.visible_sats(ephs, rcv, T0, el_mask_deg=15.0)
        prns = [p for p, _, _ in vis[:7]]
        rng = np.random.default_rng(3)
        daf0_err = {p: float(rng.uniform(-8e-8, 8e-8)) for p in prns}
        grid = _grid(mod)
        obs, bad_ephs, lt = [], {}, {}
        for p in prns:
            o = cons.simulate_observation(ephs[p], rcv, T0,
                                          rcv_clock_bias_s=1e-4)
            sp = ephs[p].position_velocity(o.t_tx_sv)[0]
            az, el = geodesy.az_el(rcv, sp)
            o.pseudorange_m += grid.slant_delay(TRUE_LLH[0], TRUE_LLH[1],
                                                az, el)
            obs.append(o)
            bad = dataclasses.replace(ephs[p], af0=ephs[p].af0 + daf0_err[p])
            bad_ephs[("G", p)] = bad
            lt[("G", p)] = mod.LongTermCorrection(
                mask_no=p, iode=bad.iode, dpos=(0.0, 0.0, 0.0),
                daf0=-daf0_err[p])
        ok = solv.solve_pvt(obs, bad_ephs, iono=None, apply_tropo=False,
                            sbas_lt=lt, sbas_iono=grid)
        off = solv.solve_pvt(obs, bad_ephs, iono=None, apply_tropo=False)
        fixes[tag] = (ok, off, rcv)
    (tok, toff, rcv), (jok, joff, _) = fixes["port"], fixes["jax"]
    np.testing.assert_allclose(tok.pos_ecef, jok.pos_ecef, rtol=0, atol=1e-6)
    np.testing.assert_allclose(toff.pos_ecef, joff.pos_ecef, rtol=0,
                               atol=1e-6)
    err_ok = np.linalg.norm(tok.pos_ecef - rcv)
    err_off = np.linalg.norm(toff.pos_ecef - rcv)
    assert err_ok < 1.0 and err_off > 5.0 and err_ok < err_off / 5.0
