"""The port's CLI (``python -m gnss_sdr_tpu_torch -c <conf>``) on the CPU.

Its argument parser has the JAX package's arguments with their defaults
(``--platform`` now chooses the receiver's device, cuda or cpu). With
``--platform cpu`` it runs a 0.5 s, 2 MSps ``ibyte`` capture (2 MB, written
to the test's temporary directory) through ``--max_chunks 3`` and exits 0,
tracking every satellite of the capture and none other, with its output
files written; without ``--platform cpu`` and without a card it exits
non-zero, never falling back to the CPU. A ``reset`` telecommand ends the
run with exit code 42; SUPL assistance comes from a QA server on 127.0.0.1,
never from the conf's default server; the notch filter runs before the
receiver on a jammed capture; a multi-source conf runs one branch per
source (two tiny files), a TCP-connector conf runs, a front-end whose
driver library is missing fails with JAX's error; only more devices than
one raise ``NotImplementedError``, naming the field.
"""

import pathlib
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

ROOT = pathlib.Path(__file__).resolve().parent.parent
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
    ("", ["--devices", "2"], "n_mesh_devices")])
def test_cli_refuses_unported(tmp_path, extra, argv, named):
    path = tmp_path / "empty.ibyte"
    path.write_bytes(b"")
    conf = _conf(tmp_path, extra, capture=path)
    with pytest.raises(NotImplementedError, match=named):
        tcli.main(["-c", conf, "--platform", "cpu"] + argv)


def test_cli_tcp_connector_and_rf_driver(tmp_path, capsys):
    """A TCP-connector conf (listeners on ephemeral ports) runs to its end
    on an empty capture; a UHD front-end without its driver library fails
    in the binding with the JAX CLI's error class and message."""
    path = tmp_path / "empty.ibyte"
    path.write_bytes(b"")
    conf = _conf(tmp_path, "Tracking_1C.implementation="
                 "GPS_L1_CA_TCP_CONNECTOR_Tracking\nTracking_1C.port_ch0=0\n",
                 capture=path)
    assert tcli.main(["-c", conf, "--platform", "cpu"]) == 0
    assert "processed: 0 samples" in capsys.readouterr().out
    conf = _conf(tmp_path, "SignalSource.implementation=UHD_Signal_Source\n",
                 capture=path)
    from gnss_sdr_tpu.config.registry import UnknownBlockError as JErr
    from gnss_sdr_tpu_torch.config.registry import UnknownBlockError as TErr
    with pytest.raises(JErr) as je:
        jcli.main(["-c", conf, "--platform", "cpu"])
    with pytest.raises(TErr) as te:
        tcli.main(["-c", conf, "--platform", "cpu"])
    assert str(te.value) == str(je.value)


def test_cli_multisource_two_files(tmp_path, capsys):
    """tests/test_multisource.py's MULTISOURCE_CONF form (GPS L1 C/A from
    source 0 at 2 MSps, GPS L5 from source 1 at 12 MSps) on two tiny
    files: one branch per source, each at its own rate, to the end of its
    file."""
    rng = np.random.default_rng(5)
    names = []
    for k, n in ((0, 4096), (1, 24000)):
        f = tmp_path / f"src{k}.ishort"
        rng.integers(-50, 50, 2 * n).astype(np.int16).tofile(f)
        names.append(f)
    conf = tmp_path / "ms.conf"
    conf.write_text(
        "GNSS-SDR.internal_fs_sps=2000000\nReceiver.sources_count=2\n"
        "Channels_1C.count=2\nChannels_L5.count=1\n"
        "Channel0.RF_channel_ID=0\nChannel2.RF_channel_ID=1\n"
        + "".join(f"SignalSource{k}.implementation=File_Signal_Source\n"
                  f"SignalSource{k}.filename={f}\n"
                  f"SignalSource{k}.item_type=ishort\n"
                  f"SignalSource{k}.sampling_frequency={fs}\n"
                  for k, f, fs in ((0, names[0], 2000000),
                                   (1, names[1], 12000000)))
        + "Resampler1.sample_freq_out=12000000\n")
    assert tcli.main(["-c", str(conf), "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "processed 2 sources, 0 PVT fixes" in out
    assert "branch 0: signals=['1C'] fs=2000000" in out
    assert "branch 1: signals=['L5'] fs=12000000" in out


def test_cli_supl_from_a_local_server(tmp_path, capsys):
    """GNSS-SDR.SUPL_* keys: the CLI fetches the assistance from the port's
    QA SLP on 127.0.0.1 (three sessions: ephemerides, almanac and
    reference location / time, acquisition hints) and applies it before
    streaming."""
    from gnss_sdr_tpu_torch.io.supl import SuplServer
    from gnss_sdr_tpu_torch.utils import constellation

    ephs = constellation.almanac_constellation()
    srv = SuplServer(ephemerides=[ephs[p] for p, _, _ in SATS],
                     ref_llh=(41.275, 1.9876, 80.0), gps_week=2240,
                     gps_tow=345600.0, n_batches=2, n_sessions=3,
                     acq_assist=[(p, d, 0.0) for p, d, _ in SATS])
    srv.start()
    conf = _conf(tmp_path, "GNSS-SDR.SUPL_gps_enabled=true\n"
                           "GNSS-SDR.SUPL_gps_ephemeris_server=127.0.0.1\n"
                           f"GNSS-SDR.SUPL_gps_ephemeris_port={srv.port}\n",
                 capture=_capture(tmp_path))
    assert tcli.main(["-c", conf, "--platform", "cpu",
                      "--max_chunks", "2"]) == 0
    srv.join(timeout=30)
    assert not srv.is_alive() and srv.error is None
    assert srv.n_acks >= 1 and srv.got_posinit is not None
    out = capsys.readouterr().out
    assert "supl: 3 ephemerides, 0 almanacs, 3 acquisition hints" in out
    assert f"tracked PRNs: {sorted(p for p, _, _ in SATS)}" in out


def test_cli_notch_filter_on_the_cpu(tmp_path, capsys):
    """InputFilter.implementation=Notch_Filter: the CLI runs the notch on
    the receiver's device before the receiver, which tracks every
    satellite of a capture with a CW jammer 30x the noise amplitude."""
    sats = [generator.SatParams(prn=p, cn0_dbhz=50.0, doppler_hz=d,
                                code_delay_s=cd) for p, d, cd in SATS]
    x = generator.generate(constants.GPS_L1_CA, sats, FS, 0.3, seed=9)
    x = x + 30.0 * np.exp(2j * np.pi * 0.31e6 * np.arange(len(x)) / FS)
    raw = np.empty(2 * len(x), np.int16)
    raw[0::2], raw[1::2] = np.round(x.real * 200), np.round(x.imag * 200)
    path = tmp_path / "jammed.ishort"
    raw.tofile(path)
    conf = _conf(tmp_path, "InputFilter.implementation=Notch_Filter\n"
                           "InputFilter.threshold_db=12\n"
                           "SignalSource.item_type=ishort\n", capture=path)
    assert tcli.main(["-c", conf, "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "input filter: Notch_Filter 3 blocks" in out
    assert f"tracked PRNs: {sorted(p for p, _, _ in SATS)}" in out


def test_cli_labsat3_conf_on_the_cpu(tmp_path, capsys):
    """conf/labsat3.conf as shipped, its capture a LabSat 3 file (4-bit
    words from the port's encoder) at 16.368 MSps: the CLI decodes it with
    the native library and decimates it 8:1 to 2.046 MSps on the
    receiver's device."""
    from gnss_sdr_tpu_torch.io import sources

    fs = 16.368e6
    sats = [generator.SatParams(prn=p, cn0_dbhz=50.0, doppler_hz=d,
                                code_delay_s=cd) for p, d, cd in SATS]
    x = generator.generate(constants.GPS_L1_CA, sats, fs, 0.25, seed=4)
    base = tmp_path / "capture"
    with open(f"{base}_0000.LS3", "wb") as f:
        f.write(sources.labsat_header(4))
        sources.encode_labsat_words(x[: len(x) // 4 * 4], 4).astype(
            "<u2").tofile(f)
    conf = ROOT / "conf" / "labsat3.conf"
    assert tcli.main(["-c", str(conf), "-s", str(base),
                      "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"tracked PRNs: {sorted(p for p, _, _ in SATS)}" in out
