"""The port's multi-source receiver (gnss_sdr_tpu_torch.receiver.
multisource) and its INI binding against the JAX package's, on the CPU.

tests/test_multisource.py's cases through both packages: the INI mapping
(two sources at 2.046 and 12 MSps; one group split across sources raises;
a single-source conf gives None; Multichannel_File_Signal_Source as N file
branches), the merged dual-band PVT over two branches' observables on its
synthetic ``world`` (the fixes bit for bit equal to JAX's) and the clock
origin shared across branches of one time scale but not across GPS and
GLONASS. Then a two-branch run of both packages' receivers: branch 0 the
first 2 s of the cached ``e2e_ms_l1`` capture (GPS L1 C/A, 2 MSps, 7
satellites; tests/test_e2e_multisource.py's key), branch 1 the first 1 s
of the cached ``e2e_gps_l5`` capture (GPS L5, 11 MSps, 4 satellites;
tests/test_e2e_l5.py's key), each read out of its npz without loading the
rest and without writing a fixture. Each branch writes its acquisition and
tracking dumps (the port's into ``source0`` / ``source1`` of one
``dump_dir``, written by ``MultiSourceReceiver.close``): the same PRNs tracked, the acquisition rows equal (the
statistics within rtol 1e-3), every tracking row's epoch equal and its
sample stamp within one sample, each channel's first 2 epochs (the
handoff) within tests/test_torch_tracking.py's rtol 1e-4 / atol 1e-4 and
every epoch within the closed-loop bounds stated in the test (the two loops
integrate noise through sums that round differently, so later epochs drift
past 1e-4: the L1 branch from its 5th epoch, the L5 branch from its 10th).
The largest gaps measured, L1 / L5 branch, against each bound: carrier
0.30 / 0.71 Hz (1 Hz), code frequency 0.19 / 1.0 chips/s (1 chip/s; 1.0 is
one float32 ulp at L5's 10.23 Mchips/s), code phase 0.0020 / 0.0098 chips
where the epoch starts on the same sample (0.01), C/N0 once settled 0.12 /
0.32 dB (0.5), the epoch's sample 1 / 1 (1).
"""

import dataclasses
import zipfile

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import constants as C
from gnss_sdr_tpu.config import ini as jini
from gnss_sdr_tpu.io import dumps as jdumps
from gnss_sdr_tpu.io.sources import ArraySignalSource as JSource
from gnss_sdr_tpu.receiver import multisource as jms
from gnss_sdr_tpu.receiver.observables import ChannelObservable
from gnss_sdr_tpu.receiver.pvt import geodesy
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu.utils import constellation, fixture_cache
from gnss_sdr_tpu.utils import scenario as scen
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource as TSource
from gnss_sdr_tpu_torch.receiver import multisource as tms
from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig as TConfig
from torch_twin import twin

torch.set_num_threads(1)   # one thread per xdist worker

TRUE_LLH = (np.deg2rad(41.275), np.deg2rad(1.9876), 80.0)
T0 = 345600.0

MULTISOURCE_CONF = """
GNSS-SDR.internal_fs_sps=2046000
Receiver.sources_count=2

SignalSource0.implementation=File_Signal_Source
SignalSource0.filename={f0}
SignalSource0.item_type=ishort
SignalSource0.sampling_frequency=2046000

SignalSource1.implementation=File_Signal_Source
SignalSource1.filename={f1}
SignalSource1.item_type=ishort
SignalSource1.sampling_frequency=12000000
Resampler1.sample_freq_out=12000000

Channels_1C.count=6
Channels_L5.count=4
Channel0.RF_channel_ID=0
Channel6.RF_channel_ID=1
"""

MULTICHANNEL_CONF = """
GNSS-SDR.internal_fs_sps=2046000

SignalSource.implementation=Multichannel_File_Signal_Source
SignalSource.total_channels=2
SignalSource.filename0={f0}
SignalSource.filename1={f1}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=2046000

Channels_1C.count=6
Channels_1B.count=4
Channel0.RF_channel_ID=0
Channel6.RF_channel_ID=1
"""


def _write_conf(tmp_path, text):
    f0, f1 = tmp_path / "l1.ishort", tmp_path / "l5.ishort"
    np.zeros(1000, np.int16).tofile(f0)
    np.zeros(1000, np.int16).tofile(f1)
    p = tmp_path / "ms.conf"
    p.write_text(text.format(f0=f0, f1=f1))
    return p


@pytest.mark.parametrize("text,signals", [
    (MULTISOURCE_CONF, ("1C", "L5")), (MULTICHANNEL_CONF, ("1C", "1B"))],
    ids=["sources_count", "multichannel"])
def test_multisource_ini_matches_jax(tmp_path, text, signals):
    path = _write_conf(tmp_path, text)
    jb, jbase = jini.multisource_from_ini(jini.FileConfiguration(path))
    tb, tbase = tini.multisource_from_ini(tini.FileConfiguration(path),
                                          device="cpu")
    assert dataclasses.asdict(tbase) == dataclasses.asdict(jbase)
    assert len(tb) == len(jb) == 2
    for t, j in zip(tb, jb):
        assert dataclasses.asdict(t.receiver) == dataclasses.asdict(j.receiver)
        assert (t.source.path, t.source.fs, t.source.item_type) == \
            (j.source.path, j.source.fs, j.source.item_type)
        assert t.input_filter is None is j.input_filter
    assert [b.receiver.signal_plan for b in tb] == [((s, n),) for s, n in
                                                   zip(signals, (6, 4))]
    if signals[1] == "L5":
        assert [b.receiver.fs for b in tb] == [2046000.0, 12000000.0]


def test_multisource_ini_refusals_match_jax(tmp_path):
    assert tini.multisource_from_ini(
        tini.InMemoryConfiguration({"Channels_1C.count": "8"})) is None
    path = _write_conf(tmp_path, MULTISOURCE_CONF
                       + "Channel1.RF_channel_ID=1\n")
    with pytest.raises(ValueError, match="splits signal group") as je:
        jini.multisource_from_ini(jini.FileConfiguration(path))
    with pytest.raises(ValueError, match="splits signal group") as te:
        tini.multisource_from_ini(tini.FileConfiguration(path), device="cpu")
    assert str(te.value) == str(je.value)


@pytest.fixture(scope="module")
def world():
    ephs = constellation.almanac_constellation()
    rcv = geodesy.geodetic_to_ecef(*TRUE_LLH)
    vis = constellation.visible_sats(ephs, rcv, T0, el_mask_deg=10.0)
    return ephs, rcv, [p for p, _, _ in vis[:6]]


def _branch_obs(ephs, prns, rcv, t, signal, bias):
    spec = C.SIGNALS[signal]
    out = []
    for prn in prns:
        o = constellation.simulate_observation(
            ephs[prn], rcv, t, rcv_clock_bias_s=bias,
            carrier_freq_hz=spec.carrier_freq_hz)
        out.append(ChannelObservable(
            prn=prn, signal=signal, t_tx_sv=o.t_tx_sv,
            pseudorange_m=o.pseudorange_m,
            carrier_phase_cycles=o.pseudorange_m
            / (C.SPEED_OF_LIGHT_M_S / spec.carrier_freq_hz),
            doppler_hz=o.doppler_hz, cn0_dbhz=47.0))
    return out


def _ms_pair(branch_cfgs):
    """The same branches as JAX's and the port's MultiSourceReceiver."""
    j = jms.MultiSourceReceiver([jms.SourceBranchConfig(receiver=JConfig(**kw))
                                 for kw in branch_cfgs])
    t = tms.MultiSourceReceiver(
        [tms.SourceBranchConfig(receiver=TConfig(**kw)) for kw in branch_cfgs],
        device="cpu")
    return j, t


def test_merged_dual_band_pvt_matches_jax(world):
    """tests/test_multisource.py:110-147: L1 observables from branch 0 and
    L5 from branch 1 merge on the tick grid into one iono-free fix per
    epoch; the port's fixes equal JAX's bit for bit."""
    ephs, rcv, prns = world
    mk = [dict(signal=sig, fs=fs, n_channels=len(prns), prns=tuple(prns),
               pvt_apply_tropo=False, pvt_apply_iono=False)
          for sig, fs in (("1C", 2.046e6), ("L5", 12.0e6))]
    jm, tm = _ms_pair(mk)
    keyed = {("G", p): ephs[p] for p in prns}
    jm.ephemerides.update(keyed)
    tm.ephemerides.update(twin(keyed, "port"))
    merged = {"jax": [], "port": []}
    jm.obs_sinks.append(lambda t, obs: merged["jax"].append((t, len(obs))))
    tm.obs_sinks.append(lambda t, obs: merged["port"].append((t, len(obs))))
    for k in range(5):
        t = T0 + 0.1 * (k + 1)
        rel = 0.1 * (k + 1)
        for bi, sig in ((0, "1C"), (1, "L5")):
            obs = _branch_obs(ephs, prns, rcv, t, sig, 1.7e-4)
            jm._collect(bi, rel, obs)
            tm._collect(bi, rel, twin(obs, "port"))
        for m in (jm, tm):
            for r in m.receivers:
                r._sample_base = int((rel + 0.05) * r.cfg.fs)
            m._flush([True, True])
    assert len(tm.fixes) == len(jm.fixes) == 5
    assert merged["port"] == merged["jax"]
    assert all(n == 2 * len(prns) for _, n in merged["port"])
    for f, g in zip(tm.fixes, jm.fixes):
        np.testing.assert_array_equal(f.pos_ecef, g.pos_ecef)
        assert (f.tow_s, f.clock_bias_s, f.n_sats) == \
            (g.tow_s, g.clock_bias_s, g.n_sats)
        assert f.n_sats == len(prns)
        assert np.linalg.norm(f.pos_ecef - rcv) < 0.3


def test_clock_origin_shared_across_branches():
    """tests/test_multisource.py:150-161, and across time scales: a GPS
    origin reaches the other GPS branch, never the GLONASS branch."""
    mk = [dict(signal="1C", fs=2.046e6), dict(signal="L5", fs=12.0e6),
          dict(signal="1G", fs=8.0e6)]
    jm, tm = _ms_pair(mk)
    for m in (jm, tm):
        assert all(r.observables.rx_clock_tow is None for r in m.receivers)
        m.receivers[0].observables._rx_origin_tow = 345601.234
        m._share_clock_origin()
    got = [r.observables.rx_clock_tow for r in tm.receivers]
    assert got == [r.observables.rx_clock_tow for r in jm.receivers]
    assert got == [345601.234, 345601.234, None]
    assert [tm._time_domain(r) for r in tm.receivers] == ["W", "W", "R"]


def _fixture_head(name: str, params: dict, n: int) -> np.ndarray:
    """The first ``n`` samples of a cached IQ fixture, read from the
    uncompressed npz member without loading the rest."""
    path = fixture_cache.cache_dir() / \
        f"{name}-{fixture_cache._key_hash(name, params)}.npz"
    if not path.exists():
        pytest.skip(f"fixture {path.name} is not cached")
    with zipfile.ZipFile(path) as z, z.open("iq.npy") as f:
        version = np.lib.format.read_magic(f)
        _, _, dtype = np.lib.format._read_array_header(f, version)
        return np.frombuffer(f.read(n * dtype.itemsize), dtype).copy()


MS_T0, MS_DUR, FS_L1, FS_L5 = 352800.08, 42.0, 2.0e6, 11.0e6


@pytest.fixture(scope="module")
def two_branch_run(tmp_path_factory):
    sc1 = scen.build_gps_l1_scenario(t0_gps=MS_T0, duration_s=MS_DUR,
                                     n_sats=7, cn0_dbhz=50.0, fs=FS_L1,
                                     el_mask_deg=10.0)
    sc5 = scen.build_gps_l5_scenario(duration_s=30.0, n_sats=4,
                                     cn0_dbhz=50.0, fs=FS_L5)
    x1 = _fixture_head("e2e_ms_l1", dict(t0=MS_T0, dur=MS_DUR, n=7, cn0=50,
                                         fs=FS_L1, seed=101), int(2 * FS_L1))
    x5 = _fixture_head("e2e_gps_l5", dict(duration_s=30.0, n_sats=4,
                                          cn0_dbhz=50.0, fs=FS_L5, seed=77),
                       int(1 * FS_L5))
    out = {}
    for tag, mod, cfg_cls, src, kw in (
            ("jax", jms, JConfig, JSource, {}),
            ("port", tms, TConfig, TSource, {"device": "cpu"})):
        dirs = [tmp_path_factory.mktemp(f"{tag}_b{k}") for k in (0, 1)]
        if tag == "port":
            # one dump_dir: the port's branches dump into its source0/1
            d = tmp_path_factory.mktemp("port_dumps")
            dirs = [d, d]
        mk = lambda sig, fs, n, prns, d: cfg_cls(         # noqa: E731
            signal=sig, fs=fs, n_channels=n, prns=tuple(prns), chunk_ms=100,
            pvt_apply_tropo=False, pvt_apply_iono=False, dump_dir=str(d))
        ms = mod.MultiSourceReceiver([
            mod.SourceBranchConfig(receiver=mk("1C", FS_L1, 7, sc1.prns,
                                               dirs[0]),
                                   source=src(x1, FS_L1)),
            mod.SourceBranchConfig(receiver=mk("L5", FS_L5, 4, sc5.prns,
                                               dirs[1]),
                                   source=src(x5, FS_L5)),
        ], **kw)
        ms.run()
        if tag == "port":
            ms.close()
            dirs = [d / "source0", d / "source1"]
        else:
            for r in ms.receivers:
                r.close_dumps()
        out[tag] = (ms, dirs)
    return sc1, sc5, out


def test_two_branches_track_as_jax(two_branch_run):
    sc1, sc5, out = two_branch_run
    (jm, _), (tm, _) = out["jax"], out["port"]
    got, want = tm.tracked_prns(), jm.tracked_prns()
    assert {k: sorted(v) for k, v in got.items()} == \
        {k: sorted(v) for k, v in want.items()}
    assert sorted(got[0]) == sorted(sc1.prns)
    assert sorted(got[1]) == sorted(sc5.prns)
    assert [r._sample_base for r in tm.receivers] == \
        [r._sample_base for r in jm.receivers]


@pytest.mark.parametrize("branch", [0, 1], ids=["l1", "l5"])
def test_two_branch_dumps_match_jax(two_branch_run, branch):
    _, _, out = two_branch_run
    jd, td = out["jax"][1][branch], out["port"][1][branch]
    za = tdumps_load(td / "acquisition.npz")
    ja = jdumps.load_dump(jd / "acquisition.npz")
    for k in ("signal", "chunk", "prn", "code_phase", "doppler_hz",
              "positive"):
        np.testing.assert_array_equal(za[k], ja[k])
    for k in ("test_cfar", "test_max_power", "magnitude"):
        np.testing.assert_allclose(za[k], ja[k], rtol=1e-3)
    zt = tdumps_load(td / "tracking.npz")
    jt = jdumps.load_dump(jd / "tracking.npz")
    for k in ("channel", "prn", "epoch"):
        np.testing.assert_array_equal(zt[k], jt[k])
    # an epoch starts on the sample where the code NCO crosses the period:
    # a code phase 1e-4 chips apart moves a few of them by one sample
    assert np.abs(zt["abs_sample"] - jt["abs_sample"]).max() <= 1
    first = zt["epoch"] < 2
    for k in ("carrier_doppler_hz", "code_freq_cps", "rem_code_phase_chips"):
        np.testing.assert_allclose(zt[k][first], jt[k][first], rtol=1e-4,
                                   atol=1e-4)
    # the closed loops over the whole run (the code phase where the epoch
    # starts on the same sample: a one-sample shift moves it by a sample's
    # worth of chips)
    same = zt["abs_sample"] == jt["abs_sample"]
    np.testing.assert_allclose(zt["rem_code_phase_chips"][same],
                               jt["rem_code_phase_chips"][same], rtol=0,
                               atol=0.01)
    for k, tol in (("carrier_doppler_hz", 1.0), ("code_freq_cps", 1.0)):
        np.testing.assert_allclose(zt[k], jt[k], rtol=0, atol=tol)
    # C/N0 once its estimator has settled (the first epochs' estimates
    # start near 0 and move fast)
    settled = (zt["cn0_dbhz"] > 30.0) & (jt["cn0_dbhz"] > 30.0)
    assert settled.mean() > 0.8
    np.testing.assert_allclose(zt["cn0_dbhz"][settled],
                               jt["cn0_dbhz"][settled], rtol=0, atol=0.5)


def tdumps_load(path):
    from gnss_sdr_tpu_torch.io import dumps as tdumps
    return tdumps.load_dump(path)
