"""The port's hybrid GPS L1 C/A + Galileo E1-B receiver on the CPU: two
signal groups (``signal_plan``) on one 4 MSps stream, each with its own
tracking loop on its slab of the shared upload.

The IQ is the first 3 s of the JAX package's cached ``e2e_hybrid`` fixture
(tests/test_e2e_hybrid.py, loaded by its exact key): only those samples are
read from the cache file, and no fixture is written while it exists. Both
groups acquire and each tracks >= 3 of its scenario's satellites; the JAX
test's fix needs ~26 s of signal and runs on the card (chip_smoke.py's
``hybrid`` phase). Two tests, for the ``--dist loadfile`` queueing reason
given in tests/test_torch_e2e.py.
"""

import zipfile

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.utils import fixture_cache, scenario as scen
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig

torch.set_num_threads(1)   # one thread per xdist worker

FS = 4.0e6
T0 = 352800.13
DUR = 26.0
WINDOW_S = 3.0


def _fixture_head(name: str, params: dict, n: int, builder) -> np.ndarray:
    """The first ``n`` samples of a cached IQ fixture, read from the
    uncompressed npz member without loading the rest; the whole fixture is
    built (and cached) only if it does not exist yet."""
    path = fixture_cache.cache_dir() / \
        f"{name}-{fixture_cache._key_hash(name, params)}.npz"
    if not path.exists():
        return fixture_cache.cached_iq(name, params, builder)[:n]
    with zipfile.ZipFile(path) as z, z.open("iq.npy") as f:
        version = np.lib.format.read_magic(f)
        _, _, dtype = np.lib.format._read_array_header(f, version)
        return np.frombuffer(f.read(n * dtype.itemsize), dtype).copy()


@pytest.fixture(scope="module")
def hybrid_run():
    sc_g = scen.build_gps_l1_scenario(t0_gps=T0, duration_s=DUR, fs=FS,
                                      n_sats=4, cn0_dbhz=47.0)
    sc_e = scen.build_galileo_e1_scenario(t0_gps=T0, duration_s=DUR, fs=FS,
                                          n_sats=4, cn0_dbhz=48.0,
                                          vis_offset=3, el_mask_deg=0.0)

    def _build():
        x = (sc_g.generate(seed=31, noise=False)
             + sc_e.generate(seed=32, noise=False))
        rng = np.random.default_rng(33)
        n = len(x)
        return (x + (rng.standard_normal(n) + 1j * rng.standard_normal(n))
                / np.sqrt(2.0)).astype(np.complex64)

    x = _fixture_head(
        "e2e_hybrid", dict(t0=T0, duration_s=DUR, fs=FS, n_sats=4,
                           seeds=(31, 32, 33), gal_vis_offset=3),
        int(WINDOW_S * FS), _build)
    cfg = ReceiverConfig(
        fs=FS, chunk_ms=100,
        signal_plan=(("1C", 4, tuple(sc_g.prns)),
                     ("1B", 4, tuple(sc_e.prns))),
        acq_doppler_max_hz=5000.0, acq_doppler_step_hz=125.0,
        pll_bw_hz=20.0, dll_bw_hz=2.0, pll_bw_narrow_hz=8.0,
        dll_bw_narrow_hz=0.75,
        pvt_apply_tropo=False, pvt_apply_iono=False)
    rx = Receiver(cfg, device="cpu")
    rx.run_source(ArraySignalSource(x, FS))
    return sc_g, sc_e, rx


def test_both_groups_acquire_and_track(hybrid_run):
    sc_g, sc_e, rx = hybrid_run
    g_grp, e_grp = rx.groups
    assert (g_grp.signal, e_grp.signal) == ("1C", "1B")
    g_tracked = {ch.prn for ch in g_grp.channels if ch.state == "tracking"}
    e_tracked = {ch.prn for ch in e_grp.channels if ch.state == "tracking"}
    assert len(g_tracked & set(sc_g.prns)) >= 3
    assert len(e_tracked & set(sc_e.prns)) >= 3
    # receiver-wide channel ids run on across the groups
    assert [ch.global_id for ch in g_grp.channels + e_grp.channels] == \
        list(range(8))


def test_groups_share_one_upload(hybrid_run):
    _, _, rx = hybrid_run
    g_grp, e_grp = rx.groups
    # one upload of chunk + the largest halo; each group reads its slab
    assert rx.n_max == e_grp.n_max == 16064 and g_grp.n_max == 4064
    assert g_grp.trk_cfg.chunk_len == e_grp.trk_cfg.chunk_len == \
        rx.chunk_len
    assert (g_grp.trk_cfg.n_steps, e_grp.trk_cfg.n_steps) == (102, 27)
    # dispatches of 102 GPS steps and of 27 Galileo steps, both groups
    # dispatched on most of the window's 30 chunks
    d = rx.tracking_dispatches
    n_gps, rest = divmod(rx.scan_steps - 27 * d, 102 - 27)
    assert rest == 0 and 20 <= n_gps <= d - 20
