"""Port SBAS L1 through the decoder and the receiver, against the JAX
package (the codec, the grid and the solver: tests/test_torch_sbas.py;
three tests a file, see there).

* ``SbasL1Telemetry``: fed the same prompts, the same messages, mask,
  fast corrections, long-term corrections, grid and GEO ephemeris.
* ``build_gps_l1_scenario``'s SBAS channel, broadcast-ephemeris errors and
  extra code delays: JAX's satellites and IQ.
* A short chain through the port's receiver on the CPU: the first 5 s of
  tests/test_e2e_sbas.py's cached capture (read from the fixture by its
  key; nothing is written), SBAS PRN 123 on one channel, decodes the MT1
  mask and an MT25. The whole 30 s scenario with the SBAS corrections off
  and on runs on the card (chip_smoke.py's ``sbas`` phase).
"""

import dataclasses
import zipfile

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.receiver import telemetry as jtlm
from gnss_sdr_tpu.utils import fixture_cache
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
from gnss_sdr_tpu_torch.models.nav import sbas as tsbas
from gnss_sdr_tpu_torch.receiver import telemetry as ttlm
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.utils import scenario as tscen

from test_torch_sbas import _fields, _messages

torch.set_num_threads(1)   # one thread per xdist worker


def test_telemetry_equals_jax_on_the_same_prompts():
    """Both decoders fed the same noisy prompts (a 2-epoch symbol stream
    that starts mid-symbol) in pushes of uneven size: the same messages,
    PRN mask, fast and long-term corrections, grid and GEO ephemeris."""
    msgs = _messages(tsbas) * 2
    sym01 = tsbas.encode_stream(msgs)
    rng = np.random.default_rng(9)
    prompts = np.repeat(60.0 * (1.0 - 2.0 * sym01.astype(np.float64)), 2)
    prompts = prompts[1:] + rng.normal(0.0, 25.0, len(prompts) - 1)
    epochs = np.arange(len(prompts)) + 7
    decoders = (ttlm.make_telemetry("1C", 123), jtlm.make_telemetry("1C", 123))
    assert isinstance(decoders[0], ttlm.SbasL1Telemetry)
    cuts = np.cumsum(rng.integers(300, 1700, 40))
    for t in decoders:
        for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(prompts)]):
            t.push(epochs[a:b], prompts[a:b])
    t, j = decoders
    assert t.message_count == j.message_count >= len(msgs) - 2
    assert [m for m, _ in t.messages] == [m for m, _ in j.messages]
    assert all(np.array_equal(a, b) for (_, a), (_, b)
               in zip(t.messages, j.messages))
    assert t.symbol_phase == j.symbol_phase
    assert t.prn_mask == j.prn_mask == [1, 5, 11, 23, 31]
    assert t.fast_corrections == j.fast_corrections
    assert {k: _fields(v) for k, v in t.long_term.items()} == \
        {k: _fields(v) for k, v in j.long_term.items()}
    assert t.iono_grid.n_points == j.iono_grid.n_points == 4
    assert dataclasses.astuple(t.geo_eph) == dataclasses.astuple(j.geo_eph)
    assert not t.have_tow and t.ephemeris() is None


def test_scenario_sbas_options_equal_jax():
    """build_gps_l1_scenario's SBAS channel, broadcast-ephemeris errors and
    extra code delays: the same satellites and 0.05 s of the same IQ."""
    from gnss_sdr_tpu.utils import scenario as jscen

    msgs = _messages(tsbas)[:2]
    kw = dict(duration_s=0.05, n_sats=4, cn0_dbhz=47.0, fs=2.0e6,
              sbas_prn=123, sbas_messages=msgs)
    base = jscen.build_gps_l1_scenario(**{k: v for k, v in kw.items()
                                          if k in ("duration_s", "n_sats",
                                                   "fs")})
    bad = {p: dataclasses.replace(base.ephemerides[p],
                                  af0=base.ephemerides[p].af0 + 5e-8)
           for p in base.prns[:2]}
    delay = {base.prns[1]: 2e-8}
    j = jscen.build_gps_l1_scenario(broadcast_ephemerides=bad,
                                    extra_code_delay_s=delay, **kw)
    tbad = {p: dataclasses.replace(tscen.build_gps_l1_scenario(
        duration_s=0.05, n_sats=4, fs=2.0e6).ephemerides[p],
        af0=base.ephemerides[p].af0 + 5e-8) for p in bad}
    t = tscen.build_gps_l1_scenario(broadcast_ephemerides=tbad,
                                    extra_code_delay_s=delay, **kw)
    assert t.prns == j.prns and t.sbas_prn == j.sbas_prn == 123
    for a, b in zip(t.sats, j.sats):
        assert a.prn == b.prn
        np.testing.assert_allclose(a.code_delay_s, b.code_delay_s,
                                   rtol=0, atol=1e-12)
        assert np.array_equal(a.data_bits, b.data_bits)
    np.testing.assert_allclose(t.generate(seed=3), j.generate(seed=3),
                               rtol=0, atol=1e-5)


def _fixture_head(name: str, params: dict, n: int):
    """The first ``n`` samples of a cached IQ fixture, read from its
    uncompressed npz member without loading the rest."""
    path = fixture_cache.cache_dir() / \
        f"{name}-{fixture_cache._key_hash(name, params)}.npz"
    if not path.exists():
        pytest.skip(f"{path.name} is not cached")
    with zipfile.ZipFile(path) as z, z.open("iq.npy") as f:
        version = np.lib.format.read_magic(f)
        _, _, dtype = np.lib.format._read_array_header(f, version)
        return np.frombuffer(f.read(n * dtype.itemsize), dtype).copy()


def test_receiver_decodes_sbas_on_the_cached_capture():
    """tests/test_e2e_sbas.py's capture (its key: the scenario's clock
    errors from default_rng(17)), its first 5 s through the port's
    receiver on the CPU with SBAS PRN 123 on one channel: the channel
    tracks, and the decoder holds the MT1 mask of the scenario's PRNs and
    an MT25's long-term corrections."""
    from gnss_sdr_tpu.utils import scenario as jscen

    fs, dur = 2.0e6, 30.0
    base = jscen.build_gps_l1_scenario(duration_s=dur, n_sats=5,
                                       cn0_dbhz=47.0, fs=fs)
    rng = np.random.default_rng(17)
    errs = {p: float(rng.uniform(4e-8, 9e-8)) * (1 if i % 2 else -1)
            for i, p in enumerate(base.prns)}
    x = _fixture_head("e2e_sbas", dict(dur=dur, fs=fs, seed=23,
                                       errs=tuple(sorted(errs.items()))),
                      int(5.0 * fs))
    rx = Receiver(ReceiverConfig(signal="1C", fs=fs, n_channels=1,
                                 prns=(123,), chunk_ms=100,
                                 pvt_apply_tropo=False, pvt_apply_iono=False),
                  device="cpu")
    rx.run_source(ArraySignalSource(x, fs))
    assert rx.tracked_prns() == [123]
    tlm = rx.groups[0].channels[0].telemetry
    assert isinstance(tlm, ttlm.SbasL1Telemetry)
    types = [m for m, _ in tlm.messages]
    assert 1 in types and 25 in types, types
    assert tlm.prn_mask == sorted(base.prns)
    for slot, c in tlm.long_term.items():
        prn = tlm.prn_mask[slot - 1]
        assert abs(c.daf0 + errs[prn]) <= 2.0 ** -31
    lt, grid = rx.sbas_corrections()
    assert lt and set(lt) <= {("G", p) for p in base.prns} and grid is None
