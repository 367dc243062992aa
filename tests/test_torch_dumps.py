"""The port's per-stage dumps (gnss_sdr_tpu_torch.io.dumps) and their
readers (gnss_sdr_tpu_torch.utils.dump_tools) against the JAX package's,
on the CPU, every file under ``tmp_path``.

tests/test_dumps.py's cases across the packages: a stage dump's npz round
trip and its MATLAB twin, each package reading the other's files to equal
arrays; the receiver with ``dump_dir`` (tracking, acquisition, observables
and PVT dumps) on tests/test_dumps.py's captures through both packages,
the acquisition rows equal (PRN, chunk, code phase, Doppler, the verdict;
the statistics within rtol 1e-3, the FFTs' rounding), the tracking rows'
sample stamps, epochs and PRNs equal, the closed loops' NCO states within
the bounds stated below and the data-bit signs equal, the dump's last rows
equal to the receiver's own channel records;
the readers per channel, and the plots only where matplotlib imports.
"""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import constants
from gnss_sdr_tpu.io import dumps as jdumps
from gnss_sdr_tpu.io.sources import ArraySignalSource as JSource
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu.utils import dump_tools as jtools
from gnss_sdr_tpu.utils import generator
from gnss_sdr_tpu_torch.io import dumps as tdumps
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource as TSource
from gnss_sdr_tpu_torch.receiver.receiver import Receiver as TReceiver
from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig as TConfig
from gnss_sdr_tpu_torch.utils import dump_tools as ttools

torch.set_num_threads(1)   # one thread per xdist worker

FS = 2.5e6


def _push_two(mod, path, mat=False):
    d = mod.StageDump(path, mat=mat)
    d.push(prompt_i=np.array([1.0, 2.0]), cn0_dbhz=np.array([44.0, 45.0]),
           n=3, tag=np.array(["1C"]))
    d.push(prompt_i=np.array([3.0]), cn0_dbhz=np.array([46.0]), n=4,
           tag=np.array(["L5"]))
    d.close()


def test_stage_dump_roundtrip_across_packages(tmp_path):
    _push_two(jdumps, tmp_path / "j.npz", mat=True)
    _push_two(tdumps, tmp_path / "t.npz", mat=True)
    for reader in (jdumps.load_dump, tdumps.load_dump):
        j, t = reader(tmp_path / "j.npz"), reader(tmp_path / "t.npz")
        assert sorted(j) == sorted(t) == ["cn0_dbhz", "n", "prompt_i", "tag"]
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    np.testing.assert_array_equal(t["prompt_i"], [1.0, 2.0, 3.0])
    from scipy.io import loadmat
    mj, mt = loadmat(tmp_path / "j.mat"), loadmat(tmp_path / "t.mat")
    for k in ("prompt_i", "cn0_dbhz", "n"):
        np.testing.assert_array_equal(mt[k], mj[k])
    # nothing pushed: no file
    tdumps.StageDump(tmp_path / "none.npz").close()
    assert not (tmp_path / "none.npz").exists()


def _capture(prn_set, dur, seed):
    return generator.generate(
        constants.GPS_L1_CA,
        [generator.SatParams(prn=7, cn0_dbhz=47, doppler_hz=900.0,
                             code_delay_s=2e-4)], FS, dur, seed=seed)


def _run(rx_cls, src_cls, cfg, x):
    rx = rx_cls(cfg, **({"device": "cpu"} if rx_cls is TReceiver else {}))
    rx.run_source(src_cls(x, FS))
    rx.close_dumps()
    return rx


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    """tests/test_dumps.py's receivers (PRN 7 at 900 Hz, 0.5 s; PRNs 7 and
    13 in the pool) through both packages, each into its own dump_dir."""
    x = _capture((7,), 0.5, seed=1)
    out = {}
    for tag, rx_cls, src, cfg_cls in (("jax", JReceiver, JSource, JConfig),
                                      ("port", TReceiver, TSource, TConfig)):
        d = tmp_path_factory.mktemp(f"dump_{tag}")
        rx = _run(rx_cls, src, cfg_cls(signal="1C", fs=FS, n_channels=1,
                                       prns=(7, 13), chunk_ms=100,
                                       dump_dir=str(d)), x)
        out[tag] = (rx, d)
    return out


def test_receiver_tracking_dump_matches_jax(dumped):
    (jrx, jd), (trx, td) = dumped["jax"], dumped["port"]
    z = tdumps.load_dump(td / "tracking.npz")
    zj = jdumps.load_dump(jd / "tracking.npz")
    # tests/test_dumps.py:20-39's checks on the port's dump
    assert len(z["prompt_i"]) > 300 and np.all(z["prn"] == 7)
    tail_i = np.abs(z["prompt_i"][-100:]).mean()
    tail_q = np.abs(z["prompt_q"][-100:]).mean()
    assert tail_i > 3 * tail_q
    assert np.all(np.diff(z["epoch"]) > 0)
    assert sorted(z) == sorted(zj)
    for k in ("channel", "prn", "abs_sample", "epoch"):
        np.testing.assert_array_equal(z[k], zj[k])
    # the two packages' loops integrate the noise through sums that round
    # differently: over these 400 epochs the carrier stays within 0.2 Hz
    # of JAX's, the code NCO within 0.125 chip/s, the code phase within
    # 1e-3 chips and C/N0 within 0.05 dB
    for k, tol in (("carrier_doppler_hz", 0.5), ("code_freq_cps", 0.5),
                   ("rem_code_phase_chips", 0.01), ("cn0_dbhz", 0.1)):
        np.testing.assert_allclose(z[k], zj[k], rtol=0, atol=tol)
    np.testing.assert_array_equal(np.sign(z["prompt_i"][-100:]),
                                  np.sign(zj["prompt_i"][-100:]))
    # the dump's last rows are the receiver's own channel records
    ch = trx.channels[0]
    recs = ch.records
    n = len(recs)
    np.testing.assert_array_equal(z["abs_sample"][-n:],
                                  [r.abs_start_sample for r in recs])
    np.testing.assert_array_equal(z["epoch"][-n:],
                                  [r.epoch_index for r in recs])
    np.testing.assert_array_equal(z["carrier_doppler_hz"][-n:],
                                  np.float32([r.carrier_freq for r in recs]))
    np.testing.assert_array_equal(z["cn0_dbhz"][-n:],
                                  np.float32([r.cn0_dbhz for r in recs]))


def test_receiver_acquisition_dump_matches_jax(dumped):
    (_, jd), (_, td) = dumped["jax"], dumped["port"]
    z = tdumps.load_dump(td / "acquisition.npz")
    zj = jdumps.load_dump(jd / "acquisition.npz")
    for k in ("signal", "chunk", "prn", "code_phase", "doppler_hz",
              "threshold", "positive"):
        np.testing.assert_array_equal(z[k], zj[k])
    for k in ("test_cfar", "test_max_power", "magnitude"):
        np.testing.assert_allclose(z[k], zj[k], rtol=1e-3)
    hits = z["positive"] & (z["prn"] == 7)
    assert hits.any()
    assert np.all(np.abs(z["doppler_hz"][hits] - 900.0) < 260.0)
    miss = z["prn"] == 13
    assert miss.any() and not z["positive"][miss].any()
    # no fix in 0.5 s: the PVT stage wrote nothing, the observables none
    assert not (td / "pvt.npz").exists() and not (jd / "pvt.npz").exists()


def test_dump_tools_read_and_plot(tmp_path):
    """tests/test_dumps.py:89-134 through both readers: per-channel
    tracking series and the PVT ENU about the mean equal; the plots where
    matplotlib imports."""
    for mod in (jdumps, tdumps):
        td = mod.TrackingDump(tmp_path / f"{mod is tdumps}" / "tracking.npz")
        n = 50
        for prn, ch in ((7, 0), (12, 1)):
            td.push_epochs(ch, prn, np.arange(n) * 2000, np.arange(n),
                           (np.ones(n) * (1 + prn)).astype(np.complex128),
                           45 + np.zeros(n), 1000.0 + np.zeros(n),
                           1.023e6 + np.zeros(n), np.zeros(n), np.ones(n))
        td.close()
        pd = mod.PvtDump(tmp_path / f"{mod is tdumps}" / "pvt.npz")

        class Sol:
            tow_s = 1.0
            pos_ecef = np.array([4.8e6, 1.6e5, 4.1e6])
            vel_ecef = np.zeros(3)
            clock_bias_s = 1e-6
            n_sats = 6
            pdop = 2.0
            hdop = 1.2
        for k in range(5):
            s = Sol()
            s.pos_ecef = Sol.pos_ecef + np.array([k * 0.1, 0, 0])
            pd.push_fix(s)
        pd.close()
    jdir, tdir = tmp_path / "False", tmp_path / "True"
    trk = ttools.read_tracking(tdir / "tracking.npz")
    jtrk = jtools.read_tracking(jdir / "tracking.npz")
    assert sorted(trk) == sorted(jtrk) == [7, 12]
    for prn in trk:
        for k in jtrk[prn]:
            np.testing.assert_array_equal(trk[prn][k], jtrk[prn][k])
    assert len(trk[7]["cn0_dbhz"]) == 50
    pvt = ttools.read_pvt(tdir / "pvt.npz")
    np.testing.assert_array_equal(
        ttools.pvt_enu(pvt), jtools.pvt_enu(jtools.read_pvt(jdir / "pvt.npz")))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert ttools.main([str(tdir), "--out", str(tmp_path / "plots")]) == 0
    assert (tmp_path / "plots" / "tracking.png").exists()
    assert (tmp_path / "plots" / "pvt.png").exists()
