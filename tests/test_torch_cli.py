"""The port's CLI (``python -m gnss_sdr_tpu_torch -c <conf>``) on the CPU.

Its argument parser has the JAX package's arguments with their defaults
(``--platform`` now chooses the receiver's device, cuda or cpu). With
``--platform cpu`` it runs a 0.5 s, 2 MSps ``ibyte`` capture (2 MB, written
to the test's temporary directory) through ``--max_chunks 3`` and exits 0,
tracking every satellite of the capture and none other, with its output
files written; without ``--platform cpu`` and without a card it exits
non-zero, never falling back to the CPU. A ``reset`` telecommand ends the
run with exit code 42; unported features (multi-source, SUPL, more devices)
raise ``NotImplementedError`` naming their key or argument.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import __main__ as jcli
from gnss_sdr_tpu_torch import __main__ as tcli
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.utils import generator

torch.set_num_threads(1)   # one thread per xdist worker

FS = 2.0e6
SATS = [(5, 1200.0, 1.7e-4), (12, -2600.0, 5.2e-4), (23, 300.0, 8.9e-4)]


def _capture(tmp_path):
    sats = [generator.SatParams(prn=p, cn0_dbhz=50.0, doppler_hz=d,
                                code_delay_s=cd) for p, d, cd in SATS]
    x = generator.generate(constants.GPS_L1_CA, sats, FS, 0.5, seed=9)
    scale = 30.0 / np.sqrt(np.mean(np.abs(x) ** 2))
    raw = np.empty(2 * len(x), np.int8)
    raw[0::2] = np.clip(np.round(x.real * scale), -127, 127)
    raw[1::2] = np.clip(np.round(x.imag * scale), -127, 127)
    path = tmp_path / "capture.ibyte"
    raw.tofile(path)
    return path


def _conf(tmp_path, extra: str, capture) -> str:
    conf = tmp_path / "rx.conf"
    conf.write_text(
        "[GNSS-SDR]\n"
        f"GNSS-SDR.internal_fs_sps={int(FS)}\n"
        "SignalSource.implementation=File_Signal_Source\n"
        f"SignalSource.filename={capture}\n"
        "SignalSource.item_type=ibyte\n"
        f"SignalSource.sampling_frequency={int(FS)}\n"
        "Channels_1C.count=4\n"
        "Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition\n"
        "Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking\n"
        "PVT.implementation=RTKLIB_PVT\n" + extra)
    return str(conf)


def test_parser_has_the_jax_arguments():
    def args(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions if a.dest != "help"}
    want, got = args(jcli.build_parser()), args(tcli.build_parser())
    assert got.pop("platform") == (("--platform",), "cuda")
    want.pop("platform")
    assert got == want


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    conf = _conf(tmp_path, f"PVT.nmea_dump_filename={tmp_path}/out.nmea\n"
                           f"PVT.rinex_obs_filename={tmp_path}/out.obs\n",
                 capture=_capture(tmp_path))
    assert tcli.main(["-c", conf, "--platform", "cpu",
                      "--max_chunks", "3"]) == 0
    out = capsys.readouterr().out
    # three 100 ms blocks read; the third is the second's halo at the end
    assert "processed: 400000 samples" in out
    assert f"tracked PRNs: {sorted(p for p, _, _ in SATS)}" in out
    assert "tracking_dispatches=2 tracking_kernel_launches=0" in out
    assert (tmp_path / "out.nmea").exists()
    assert (tmp_path / "out.obs").exists()


def test_cli_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the run on a machine without a card")
    conf = _conf(tmp_path, "", tmp_path / "none.ibyte")
    with pytest.raises(SystemExit) as e:
        tcli.main(["-c", conf])
    assert "no CUDA device" in str(e.value.code)


def test_cli_reset_returns_42(tmp_path):
    rng = np.random.default_rng(2)
    noise = tmp_path / "noise.ibyte"
    (rng.standard_normal(int(FS)) * 20).astype(np.int8).tofile(noise)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    conf = _conf(tmp_path, "GNSS-SDR.telecommand_enabled=true\n"
                           f"GNSS-SDR.telecommand_tcp_port={port}\n"
                           "GNSS-SDR.chunk_ms=20\n", capture=noise)

    def send_reset():
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=3)
                s.sendall(b"reset\n")
                s.recv(64)
                s.close()
                return
            except OSError:
                time.sleep(0.05)

    t = threading.Thread(target=send_reset, daemon=True)
    t.start()
    assert tcli.main(["-c", conf, "--platform", "cpu"]) == 42
    t.join(timeout=5)


@pytest.mark.parametrize("extra,argv,named", [
    ("Receiver.sources_count=2\n", [], "Receiver.sources_count"),
    ("GNSS-SDR.SUPL_gps_enabled=true\n", [], "GNSS-SDR.SUPL_gps_enabled"),
    ("", ["--devices", "2"], "n_mesh_devices"),
    ("InputFilter.implementation=Notch_Filter\n", [],
     "InputFilter.implementation=Notch_Filter")])
def test_cli_refuses_unported(tmp_path, extra, argv, named):
    path = tmp_path / "empty.ibyte"
    path.write_bytes(b"")
    conf = _conf(tmp_path, extra, capture=path)
    with pytest.raises(NotImplementedError, match=named):
        tcli.main(["-c", conf, "--platform", "cpu"] + argv)
