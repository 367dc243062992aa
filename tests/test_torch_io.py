"""Port signal sources (gnss_sdr_tpu_torch.io.sources) against the JAX
package: every item type of a raw capture decodes to the same complex64
samples, chunk by chunk, through both ``FileSignalSource`` classes; and the
port's ``Receiver.run_file_source`` on a capture file does what
``run_source`` does on the same samples in memory. The files are small and
live in pytest's temporary directory."""

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.io import sources as jsrc
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.io import sources as tsrc
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.utils import generator

torch.set_num_threads(1)   # one thread per xdist worker


@pytest.mark.parametrize("item_type", sorted(tsrc.ITEM_TYPES))
def test_file_source_matches_jax(tmp_path, item_type):
    rng = np.random.default_rng(7)
    dtype, comps = tsrc.ITEM_TYPES[item_type]
    n = 1000
    if item_type == "gr_complex":
        raw = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
               ).astype(np.complex64)
    elif np.dtype(dtype).kind == "f":
        raw = rng.standard_normal(n * comps).astype(dtype)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max + 1, n * comps).astype(dtype)
    path = tmp_path / f"capture_{item_type}.bin"
    raw.tofile(path)
    # a valve below the file length, read in uneven chunks past its end
    a = tsrc.FileSignalSource(path, item_type, 2e6, samples=900)
    b = jsrc.FileSignalSource(path, item_type, 2e6, samples=900)
    assert a.total_samples == b.total_samples == 900
    for size in (128, 333, 500, 100):
        x, y = a.read(size), b.read(size)
        assert x.dtype == np.complex64
        np.testing.assert_array_equal(x, y)
    assert len(a.read(10)) == 0
    # repeating sources wrap around to the start
    r = tsrc.FileSignalSource(path, item_type, 2e6, samples=300, repeat=True)
    np.testing.assert_array_equal(
        r.read(700), np.concatenate([tsrc.decode_samples(
            raw[: 300 * comps], item_type)] * 3)[:700])


def test_run_file_source_equals_run_source(tmp_path):
    fs = 2.0e6
    sats = [generator.SatParams(prn=p, cn0_dbhz=50.0, doppler_hz=d,
                                code_delay_s=cd)
            for p, d, cd in [(4, 1500.0, 2.1e-4), (9, -2200.0, 6.3e-4)]]
    x = generator.generate(constants.GPS_L1_CA, sats, fs, 0.8, seed=5)
    path = tmp_path / "capture.dat"
    x.astype(np.complex64).tofile(path)

    def receiver():
        return Receiver(ReceiverConfig(
            signal="1C", fs=fs, n_channels=3, prns=(4, 9, 17), chunk_ms=100,
            pvt_enabled=False), device="cpu")

    a, b = receiver(), receiver()
    a.run_source(tsrc.ArraySignalSource(x, fs))
    b.run_file_source(tsrc.FileSignalSource(path, "gr_complex", fs))
    assert sorted(a.tracked_prns()) == sorted(b.tracked_prns()) == [4, 9]
    assert a._sample_base == b._sample_base > 0
    assert a.scan_steps == b.scan_steps > 0
    for ca, cb in zip(a.groups[0].channels, b.groups[0].channels):
        assert ca.prn == cb.prn
        if ca.prn is not None:
            ra = ca.latest_record_before(a._sample_base)
            rb = cb.latest_record_before(b._sample_base)
            assert ra == rb
    # a source at twice the internal rate is decimated by 2 on the way in:
    # two 200 ms blocks give 400 ms at 2 MSps, one chunk plus its halo
    c = receiver()
    c.run_file_source(tsrc.FileSignalSource(path, "gr_complex", 4e6),
                      max_chunks=2)
    assert c._sample_base == c.chunk_len
