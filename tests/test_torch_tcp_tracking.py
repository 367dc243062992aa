"""The port's TCP-connector tracking (gnss_sdr_tpu_torch.receiver.
tcp_tracking) against the JAX package's, on the CPU, over 127.0.0.1.

tests/test_tcp_tracking.py's cases, across the packages: the wire format
(9 float32 LE to the peer, 4 back) with a raw peer, packet for packet
against JAX's engine's; the closed loop, the port's peer bit for bit
against JAX's peer on JAX's engine, and the port's engine against JAX's
engine under JAX's peer within stated bounds and JAX's budgets; the INI
binding; and the port's receiver with a TCP group (acquisition on the
receiver's device, the loops stepped on the host, each epoch's taps from
the epoch multicorrelator, no fused tracking kernel) whose channel records
agree with the JAX receiver's. The port's engine correlates in float32 with
the multicorrelator's plain version (the card's kernel gives its bits), the
JAX engine in float64 numpy, so taps differ in their last bits and the
closed loops drift apart by the gaps given at each bound. Every socket has
a timeout and every peer thread is joined with a limit.
"""

import dataclasses
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from gnss_sdr_tpu import constants
from gnss_sdr_tpu.config.ini import InMemoryConfiguration as JConf
from gnss_sdr_tpu.config.ini import receiver_config_from_ini as jbind
from gnss_sdr_tpu.io.sources import ArraySignalSource as JSource
from gnss_sdr_tpu.models import codes
from gnss_sdr_tpu.receiver import tcp_tracking as jtcp
from gnss_sdr_tpu.receiver.receiver import Receiver as JReceiver
from gnss_sdr_tpu.receiver.receiver import ReceiverConfig as JConfig
from gnss_sdr_tpu.utils import generator
from gnss_sdr_tpu_torch.config import ini as tini
from gnss_sdr_tpu_torch.io.sources import ArraySignalSource as TSource
from gnss_sdr_tpu_torch.ops import tracking_kernel as tk
from gnss_sdr_tpu_torch.receiver import tcp_tracking as ttcp
from gnss_sdr_tpu_torch.receiver.receiver import Receiver as TReceiver
from gnss_sdr_tpu_torch.receiver.receiver import ReceiverConfig as TConfig

torch.set_num_threads(1)   # one thread per xdist worker

SPEC = constants.GPS_L1_CA
FS = 2.5e6
FD_TRUE = 1234.0
DELAY_S = 0.0003
N_MAX = int(FS * 1e-3) + 64


def _capture(duration_s: float, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(1)
    bits = generator.lnav_bits_to_symbols(rng.integers(0, 2, 200))
    return generator.generate(
        SPEC, [generator.SatParams(prn=7, cn0_dbhz=48.0, doppler_hz=FD_TRUE,
                                   code_delay_s=DELAY_S, data_bits=bits)],
        FS, duration_s, seed=seed)


def _raw_peer(port: int, got: list) -> threading.Thread:
    """A peer that records every packet and commands no correction."""
    def run():
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            while True:
                buf = b""
                while len(buf) < 36:
                    part = s.recv(36 - len(buf))
                    if not part:
                        return
                    buf += part
                pkt = struct.unpack("<9f", buf)
                if pkt[8] == 0.0:
                    return
                got.append(pkt)
                s.sendall(struct.pack("<4f", pkt[0], 0.0, 0.0, pkt[7]))
        finally:
            s.close()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _start(eng, doppler: float = FD_TRUE) -> None:
    code_freq = SPEC.code_rate_cps * (1 + doppler / SPEC.carrier_freq_hz)
    eng.start_channel(0, code_table=codes.code_chips("1C", 7),
                      code_freq=code_freq, doppler_hz=doppler,
                      sample_offset=round(DELAY_S * FS))


def test_wire_format_matches_jax():
    """The port's engine sends JAX's packets: 9 float32 LE [id, E, L, P
    (re / im), acq Doppler, enable], ids from 1; id, Doppler and enable
    equal, the taps within 1e-6 of the packet's largest tap (measured gap
    3.5e-7: float32 against float64 sums; the peer commands no correction,
    so both engines step the same NCOs)."""
    x = _capture(0.12)
    chunk_len = int(FS * 0.05)
    packets = []
    for mod in (jtcp, ttcp):
        eng = mod.TcpTrackingEngine(spec=SPEC, fs=FS, n_channels=1,
                                    n_steps=55, n_max=N_MAX, port_ch0=0)
        got: list = []
        t = _raw_peer(eng.ports[0], got)
        _start(eng)
        eng.process_chunk(x[: chunk_len + eng.n_max], chunk_len)
        eng.close()
        t.join(timeout=5)
        assert not t.is_alive()
        packets.append(np.asarray(got))
    jgot, tgot = packets
    assert len(tgot) >= 40 and tgot.shape == jgot.shape
    np.testing.assert_array_equal(tgot[:, [0, 7, 8]], jgot[:, [0, 7, 8]])
    scale = np.abs(jgot[:, 1:7]).max(axis=1, keepdims=True)
    assert (np.abs(tgot[:, 1:7] - jgot[:, 1:7]) <= 1e-6 * scale).all()
    assert list(tgot[:, 0]) == list(range(1, len(tgot) + 1))
    assert all(p[7] == pytest.approx(FD_TRUE) and p[8] == 1.0 for p in tgot)


def _closed_loop(eng_mod, peer_mod, x, chunks: int = 30):
    eng = eng_mod.TcpTrackingEngine(spec=SPEC, fs=FS, n_channels=1,
                                    n_steps=55, n_max=N_MAX, port_ch0=0)
    peer = peer_mod.LoopFilterPeer(eng.ports[0], code_period_s=1e-3)
    peer.start()
    _start(eng, FD_TRUE + 40.0)        # half an acq bin of initial error
    chunk_len = int(FS * 0.05)
    outs = []
    for k in range(chunks):
        base = k * chunk_len
        f32, i32, lol = eng.process_chunk(
            x[base: base + chunk_len + eng.n_max], chunk_len)
        outs.append((f32, i32, lol))
    eng.close()
    peer.join(timeout=10)
    assert not peer.is_alive()
    if peer.error:
        raise peer.error
    return outs


def _assert_loops_agree(fa, ia, fb, ib):
    """Two engines' packed outputs: the valid flags and the integer fields
    (epoch, sample offset, carrier cycles) equal; the float fields within
    these bounds (the largest gap measured on the closed-loop case in
    brackets): code phase 1e-3 chips [5.9e-5], code frequency 0.5 chips/s
    [0.0625], carrier 0.5 Hz [0.20], carrier phase fraction 2e-3 cycles on
    the circle [2.0e-4], C/N0 0.2 dB [0.036], carrier lock 1e-3 [4.1e-5],
    the prompt within 2 % of its largest magnitude [0.7 %]."""
    np.testing.assert_array_equal(fa[..., 8], fb[..., 8])
    np.testing.assert_array_equal(ia, ib)
    v = fb[..., 8] > 0.5
    for k, tol in ((2, 1e-3), (3, 0.5), (4, 0.5), (6, 0.2), (7, 1e-3)):
        assert np.abs(fa[..., k] - fb[..., k])[v].max() <= tol, k
    d = (fa[..., 5] - fb[..., 5])[v]
    assert np.abs(d - np.round(d)).max() <= 2e-3
    prompt = np.abs(fb[..., 0] + 1j * fb[..., 1])[v].max()
    gap = np.abs((fa[..., 0] - fb[..., 0]) + 1j * (fa[..., 1] - fb[..., 1]))
    assert gap[v].max() <= 0.02 * prompt


def test_closed_loop_across_packages():
    """The port's peer closes JAX's engine's loops bit for bit as JAX's
    peer does (both peers are the same numpy filter); the port's engine
    under JAX's peer agrees with JAX's engine under it
    (:func:`_assert_loops_agree`) and meets tests/test_tcp_tracking.py's
    budgets (carrier within 3 Hz, code within 0.02 chips, C/N0 42-54)."""
    x = _capture(1.6)
    a = _closed_loop(ttcp, jtcp, x)
    b = _closed_loop(jtcp, jtcp, x)
    c = _closed_loop(jtcp, ttcp, x)
    for (fb, ib, lb), (fc, ic, lc) in zip(b, c):
        np.testing.assert_array_equal(fc, fb)
        np.testing.assert_array_equal(ic, ib)
        np.testing.assert_array_equal(lc, lb)
    _assert_loops_agree(*(np.concatenate([o[i] for o in a]) for i in (0, 1)),
                        *(np.concatenate([o[i] for o in b]) for i in (0, 1)))
    assert all((la == lb).all() for (_, _, la), (_, _, lb) in zip(a, b))
    chunk_len = int(FS * 0.05)
    rows = []
    for k, (f32, i32, _) in enumerate(a):
        for s in np.nonzero(f32[:, 0, 8] > 0.5)[0]:
            rows.append((k * chunk_len + i32[s, 0, 1], f32[s, 0, 2],
                         f32[s, 0, 4], f32[s, 0, 6]))
    tail = rows[-100:]
    assert abs(np.median([r[2] for r in tail]) - FD_TRUE) < 3.0
    true_codef = SPEC.code_rate_cps * (1 + FD_TRUE / SPEC.carrier_freq_hz)
    errs = []
    for s0, rem, _, _ in tail:
        d = (((s0 / FS - DELAY_S) * true_codef) % 1023.0 - rem) % 1023.0
        errs.append(d - 1023.0 if d > 511 else d)
    assert np.median(np.abs(errs)) < 0.02
    assert 42.0 < np.median([r[3] for r in tail]) < 54.0


def test_ini_maps_tcp_connector_implementation():
    keys = {"GNSS-SDR.internal_fs_sps": "2500000", "Channels_1C.count": "2",
            "Tracking_1C.implementation": "GPS_L1_CA_TCP_CONNECTOR_Tracking",
            "Tracking_1C.port_ch0": "0"}
    want = jbind(JConf(dict(keys)))
    got = tini.receiver_config_from_ini(tini.InMemoryConfiguration(keys))
    assert got.tcp_connector and want.tcp_connector
    assert dict(dict(got.group_params)["1C"])["tcp_port_ch0"] == 0
    assert got.group_params == want.group_params


def _run_tcp_receiver(rx_cls, cfg, src, peer_mod, x):
    rx = rx_cls(cfg, **({"device": "cpu"} if rx_cls is TReceiver else {}))
    g = rx.groups[0]
    peers = [peer_mod.LoopFilterPeer(p, code_period_s=1e-3)
             for p in g.tcp_engine.ports]
    for p in peers:
        p.start()
    try:
        rx.run_source(src(x, FS))
    finally:
        rx.close()
        for p in peers:
            p.join(timeout=10)
    for p in peers:
        assert not p.is_alive()
        if p.error:
            raise p.error
    return rx


def test_receiver_runs_tcp_connector_group():
    """tests/test_tcp_tracking.py:148-170 on the port's receiver: the
    acquisition hands off to the TCP engine, the peer closes the loops,
    records and telemetry accumulate; no fused tracking kernel dispatch,
    one multicorrelator call per round of the engine. The JAX receiver on
    the same capture keeps the same channel records: the sample, epoch and
    carrier-cycle fields equal, the others within the bounds of
    :func:`_assert_loops_agree` (largest gaps measured: code phase 1.2e-5
    chips, code frequency 0, carrier 0.036 Hz, phase fraction 3.8e-5
    cycles, C/N0 0.0054 dB)."""
    x = _capture(1.2, seed=5)
    kw = dict(signal="1C", fs=FS, n_channels=1, prns=(7,), chunk_ms=50,
              tcp_connector=True, tcp_port_ch0=0)
    tk.launches = 0
    trx = _run_tcp_receiver(TReceiver, TConfig(**kw), TSource, ttcp, x)
    ch = trx.groups[0].channels[0]
    assert ch.state == "tracking" and ch.prn == 7
    assert len(ch.records) > 0
    last = ch.records[-1]
    assert abs(last.carrier_freq - FD_TRUE) < 5.0
    assert last.cn0_dbhz > 40.0
    assert trx.tracking_dispatches == 0 and tk.launches == 0
    eng = trx.groups[0].tcp_engine
    assert eng.epochs >= eng.rounds > 0
    jrx = _run_tcp_receiver(JReceiver, JConfig(**kw), JSource, jtcp, x)
    got = [dataclasses.asdict(r) for r in ch.records]
    want = [dataclasses.asdict(r) for r in jrx.groups[0].channels[0].records]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("abs_start_sample", "epoch_index", "carr_phase_cycles"):
            assert g[f] == w[f], f
        for f, tol in (("rem_code_phase", 1e-3), ("code_freq", 0.5),
                       ("carrier_freq", 0.5), ("cn0_dbhz", 0.2)):
            assert abs(g[f] - w[f]) <= tol, f
        d = g["carr_phase_frac"] - w["carr_phase_frac"]
        assert abs(d - round(d)) <= 2e-3
