"""The port's control plane (gnss_sdr_tpu_torch.receiver.control and the
``Receiver`` methods that serve it) against the JAX package's, on the CPU.

The telecommand server answers on localhost with JAX's replies and queues
the same events; assistance JSON written by the port is byte-identical to
JAX's and each package loads the other's; ``predicted_doppler`` is equal to
the last bit; ``_dispatch_commands`` leaves a CPU receiver in JAX's state
for every command. ``set_ch_satellite`` is also run on a receiver holding
the packed tracking carry (the card's form): its acquisition handoff to the
pinned channel (unpack -> edit -> pack) gives, bit for bit, the packed form
of the NamedTuple receiver's carry. Reset and stop end the run loop.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest
import torch

from gnss_sdr_tpu.models.almanac import GpsAlmanac as JAlm
from gnss_sdr_tpu.models.ephemeris import IonoParams as JIono
from gnss_sdr_tpu.models.ephemeris import KeplerEphemeris as JEph
from gnss_sdr_tpu.receiver import control as jctl
from gnss_sdr_tpu.receiver import receiver as jrx
from gnss_sdr_tpu_torch import constants
from gnss_sdr_tpu_torch.io import sources
from gnss_sdr_tpu_torch.models.almanac import GpsAlmanac
from gnss_sdr_tpu_torch.models.ephemeris import IonoParams
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import control as tctl
from gnss_sdr_tpu_torch.receiver import receiver as trx
from gnss_sdr_tpu_torch.receiver.pvt import geodesy
from gnss_sdr_tpu_torch.utils import constellation, generator

torch.set_num_threads(1)   # one thread per xdist worker


def _send_lines(port, lines) -> list:
    s = socket.create_connection(("127.0.0.1", port), timeout=3)
    f = s.makefile("rw")
    out = []
    for line in lines:
        f.write(line + "\n")
        f.flush()
        out.append(f.readline().strip())
    s.close()
    return out


def test_telecommand_server_answers_as_jax():
    lines = ["status", "standby", "coldstart", "hotstart", "reset",
             "set_ch_satellite 2 17", "set_ch_satellite 2 x", "bogus",
             "quit"]
    got = {}
    for tag, mod in (("jax", jctl), ("port", tctl)):
        q = mod.ControlQueue()
        srv = mod.TelecommandServer(q, status_fn=lambda: "STATUS-OK")
        try:
            replies = _send_lines(srv.port, lines)
            time.sleep(0.1)
            got[tag] = (replies, [(c.command, c.args) for c in q.pop_all()])
        finally:
            srv.close()
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == "STATUS-OK"
    assert got["port"][1][-1] == ("set_ch_satellite", (2, 17))


def _assistance_inputs(pkg):
    eph = constellation.almanac_constellation()[7]
    eph.iode, eph.iodc = 21, 277
    jalm = JAlm.from_ephemeris(JEph(**dataclasses.asdict(eph)))
    iono = dict(alpha=(1e-8, 2e-8, -1e-7, 3e-8),
                beta=(88064.0, 0.0, -196608.0, 0.0), valid=True)
    if pkg == "jax":
        eph, alm, iono = JEph(**dataclasses.asdict(eph)), jalm, JIono(**iono)
    else:
        alm = GpsAlmanac(**dataclasses.asdict(jalm))
        iono = IonoParams(**iono)
    return dict(ephemerides={("G", 7): eph}, iono=iono,
                almanacs={("G", 7): alm},
                position_ecef=np.array([4.7e6, 1.6e5, 4.1e6]),
                tow_s=345601.5)


def test_assistance_json_matches_jax(tmp_path):
    pj, pt = tmp_path / "jax.json", tmp_path / "port.json"
    jctl.save_assistance(pj, **_assistance_inputs("jax"))
    tctl.save_assistance(pt, **_assistance_inputs("port"))
    assert pt.read_bytes() == pj.read_bytes()
    for a, b in ((tctl.load_assistance(pj), jctl.load_assistance(pt)),
                 (tctl.load_assistance(pt), jctl.load_assistance(pj))):
        assert (dataclasses.asdict(a.ephemerides[("G", 7)])
                == dataclasses.asdict(b.ephemerides[("G", 7)]))
        assert (dataclasses.asdict(a.almanacs[("G", 7)])
                == dataclasses.asdict(b.almanacs[("G", 7)]))
        assert dataclasses.asdict(a.iono) == dataclasses.asdict(b.iono)
        np.testing.assert_array_equal(a.position_ecef, b.position_ecef)
        assert a.tow_s == b.tow_s
    empty = tctl.load_assistance(tmp_path / "nope.json")
    assert empty.ephemerides == {} and empty.position_ecef is None


def test_predicted_doppler_matches_jax():
    ephs = constellation.almanac_constellation()
    rcv = geodesy.geodetic_to_ecef(np.deg2rad(41.275), np.deg2rad(1.9876),
                                   80.0)
    vis = constellation.visible_sats(ephs, rcv, 354000.0)
    for prn, _, _ in vis[:4]:
        want = jctl.predicted_doppler(JEph(**dataclasses.asdict(ephs[prn])),
                                      rcv, 354000.0, 1.57542e9)
        assert tctl.predicted_doppler(ephs[prn], rcv, 354000.0,
                                      1.57542e9) == want


def _summary(rx) -> dict:
    g = rx.groups[0]
    return dict(standby=rx.standby, restart=rx.restart_requested,
                stop=rx.stop_requested,
                channels=[(c.prn, c.state) for c in g.channels],
                backoff=dict(g.acq_backoff), fails=dict(g.acq_fails),
                pinned=dict(g.pinned), pool=list(g.acq_pool),
                ephemerides=sorted(rx.ephemerides), iono=rx.iono is None)


@pytest.mark.parametrize("command,args", [
    ("standby", ()), ("coldstart", ()), ("warmstart", ()), ("hotstart", ()),
    ("reset", ()), ("stop", ()), ("set_ch_satellite", (1, 21))])
def test_dispatch_commands_as_jax(command, args):
    got = {}
    for tag, rxmod, ctl in (("jax", jrx, jctl), ("port", trx, tctl)):
        cfg = rxmod.ReceiverConfig(signal="1C", fs=2e6, n_channels=3,
                                   prns=(3, 7, 9))
        rx = (rxmod.Receiver(cfg) if rxmod is jrx
              else rxmod.Receiver(cfg, device="cpu"))
        g = rx.groups[0]
        rx._assign_channel(g, g.channels[0], 7, 120, 1500.0)
        g.acq_fails[3] = 2
        g.acq_backoff[3] = 40
        rx.ephemerides[("G", 7)] = object()
        rx.iono = object()
        rx.control_queue.push(ctl.CommandEvent(command, args))
        rx._dispatch_commands()
        got[tag] = _summary(rx)
    assert got["port"] == got["jax"]


def _signal(duration_s: float, seed: int = 3):
    sats = [generator.SatParams(prn=p, cn0_dbhz=50.0, doppler_hz=d,
                                code_delay_s=cd)
            for p, d, cd in [(4, 1500.0, 2.1e-4), (9, -2200.0, 6.3e-4)]]
    return generator.generate(constants.GPS_L1_CA, sats, 2e6, duration_s,
                              seed=seed)


def test_set_ch_satellite_on_packed_carry():
    """The pinned handoff through the packed carry equals pack() of the
    NamedTuple receiver's carry, and the pin holds."""
    x = _signal(0.2)
    rxs = []
    for packed in (False, True):
        rx = trx.Receiver(trx.ReceiverConfig(
            signal="1C", fs=2e6, n_channels=3, prns=(4, 17),
            pvt_enabled=False), device="cpu")
        g = rx.groups[0]
        if packed:
            g.trk_state = tk.pack_carry(g.trk_state)
        rx.control_queue.push(tctl.CommandEvent("set_ch_satellite", (2, 9)))
        rx.process(x)
        rxs.append(rx)
    plain, packed = rxs
    assert [(c.prn, c.state) for c in packed.groups[0].channels] == [
        (4, "tracking"), (None, "idle"), (9, "tracking")]
    assert ([(c.prn, c.state) for c in plain.groups[0].channels]
            == [(c.prn, c.state) for c in packed.groups[0].channels])
    assert isinstance(packed.groups[0].trk_state, torch.Tensor)
    assert torch.equal(tk.pack_carry(plain.groups[0].trk_state),
                       packed.groups[0].trk_state)


@pytest.mark.parametrize("command", ["reset", "stop"])
def test_reset_and_stop_end_the_run_loop(tmp_path, command):
    rng = np.random.default_rng(1)
    fs = 1.023e6
    path = tmp_path / "noise.dat"
    (rng.standard_normal(int(fs)) * 40).astype(np.int16).tofile(path)
    rx = trx.Receiver(trx.ReceiverConfig(
        signal="1C", fs=fs, n_channels=1, chunk_ms=20, prns=(1,)),
        device="cpu")
    rx.control_queue.push(tctl.CommandEvent(command))
    rx.run_file_source(sources.FileSignalSource(
        path, item_type="ishort", sampling_frequency=fs))
    assert rx.restart_requested == (command == "reset")
    assert rx.stop_requested == (command == "stop")
    assert rx._sample_base <= 2 * rx.chunk_len


def test_checkpoint_restore(tmp_path):
    cfg = trx.ReceiverConfig(signal="1C", fs=2e6, n_channels=1)
    rx = trx.Receiver(cfg, device="cpu")
    eph = constellation.almanac_constellation()[7]
    rx.ephemerides[("G", 7)] = eph
    rx.assist_pos, rx.assist_tow = np.array([4.7e6, 1.6e5, 4.1e6]), 1234.5
    rx.checkpoint(tmp_path / "ck.json")
    rx2 = trx.Receiver(cfg, device="cpu")
    rx2.restore(tmp_path / "ck.json")
    assert (dataclasses.asdict(rx2.ephemerides[("G", 7)])
            == dataclasses.asdict(eph))
    np.testing.assert_array_equal(rx2.assist_pos, rx.assist_pos)
    assert rx2.assist_tow == 1234.5
