"""TCP-connector tracking: loop closure through an external process.

Analog of the reference's hardware/software-in-the-loop research blocks
``src/algorithms/tracking/gnuradio_blocks/gps_l1_ca_tcp_connector_tracking_cc.cc``
and ``galileo_e1_tcp_connector_tracking_cc.cc`` with the wire protocol of
``src/algorithms/tracking/libs/tcp_communication.cc`` / ``tcp_packet_data.h``:
each code epoch, the receiver correlates the taps locally, ships them to an
external peer (originally a MATLAB session) over TCP, and the peer returns
the loop-filter outputs that steer the code/carrier NCOs.

Wire format (float32 little-endian, one packet per epoch, receiver listens
on ``port_ch0 + channel`` and the peer connects):

  GPS L1 C/A  TX (9):  [control_id, E.re, E.im, L.re, L.im, P.re, P.im,
                        acq_doppler_hz, enable]
  Galileo E1  TX (13): [control_id, VE.re, VE.im, E.re, E.im, L.re, L.im,
                        VL.re, VL.im, P.re, P.im, acq_doppler_hz, enable]
  RX (4):              [control_id_echo, code_error_chips,
                        carr_error, carrier_doppler_hz]

The receiver applies the reply exactly as the reference does
(gps_l1_ca_tcp_connector_tracking_cc.cc:405-441): the carrier NCO is set to
the returned absolute Doppler and the code NCO to
``1 / (1/code_rate - code_error/code_length)`` — i.e. "slew ``code_error``
chips over the next code period".

Design note: the synchronous per-epoch round trip to an external process is
what this block *is*, so the epoch loop is stepped on the HOST: each round
of the loop correlates the next epoch of every channel that has one with
the epoch multicorrelator (``ops/correlator.batch_epoch_correlate``: the
kernel ``csrc/correlator.cu`` on the card, its plain version on the CPU) on
the chunk where the receiver uploaded it, downloads only the K complex taps
of each channel, and then trades each channel's packet with its peer. A TCP
group launches no fused tracking kernel: its NCOs and loop filters step
between two epochs on the host, as the reference block's do. The chunk
outputs are packed in the ``[S, C, 9]`` / ``[S, C, 3]`` layout of
``tracking.unpack_host_outputs`` so telemetry, observables and PVT
downstream are unchanged. Every socket has a timeout (``timeout_s``), so a
silent peer raises instead of hanging the receiver. ``seconds`` splits the
engine's time between the correlations (launch and download included) and
the exchanges with the peers.

``LoopFilterPeer`` is a built-in peer implementing the discriminator +
loop-filter side (the role of the reference's MATLAB helpers in
``src/utils/matlab/libs/``), so the block is usable and testable without an
external MATLAB session.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import struct
import threading
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch.ops import correlator, iq

log = logging.getLogger(__name__)

# tap sets in wire order; the prompt is always the last entry
_GPS_TAPS = np.array([-0.5, 0.5, 0.0], np.float32)              # E, L, P
_VEML_TAPS = np.array([-0.6, -0.15, 0.15, 0.6, 0.0], np.float32)  # VE,E,L,VL,P


def _as_iq2(x) -> torch.Tensor:
    """The chunk as float32 split-IQ [L, 2] on its own device: a tensor in
    any of ops/iq.py's forms, complex numpy samples (rounded to complex64,
    as the reference engine takes them) or split-IQ numpy [L, 2]."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x = x.astype(np.complex64)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return iq.as_iq2(x).contiguous()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("TCP loop peer closed the connection")
        buf += part
    return buf


class TcpLoopLink:
    """One listening socket per channel (reference
    Tcp_Communication::listen_tcp_connection binds ``port_ch0 + channel``
    and blocks for the peer)."""

    def __init__(self, port: int):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._conn: socket.socket | None = None

    def accept(self, timeout_s: float = 30.0) -> None:
        if self._conn is not None:
            return
        self._srv.settimeout(timeout_s)
        self._conn, peer = self._srv.accept()
        self._conn.settimeout(timeout_s)
        self._conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        log.info("TCP loop peer %s connected on port %d", peer, self.port)

    def exchange(self, tx: np.ndarray) -> tuple[float, float, float]:
        """Send one epoch packet, block for the 4-float reply.

        Returns (code_error_chips, carr_error, carrier_doppler_hz); raises
        if the echoed control id mismatches (reference: "Packet error!").
        """
        assert self._conn is not None, "peer not connected"
        self._conn.sendall(tx.astype("<f4").tobytes())
        rx = struct.unpack("<4f", _recv_exact(self._conn, 16))
        if rx[0] != tx[0]:
            raise RuntimeError(
                f"TCP loop packet error: control id {rx[0]} != {tx[0]}")
        return rx[1], rx[2], rx[3]

    def send_terminal(self, n_tx: int) -> None:
        """Final packet with enable=0 (reference sends all-ones, enable 0,
        on flowgraph teardown so the peer's read loop exits)."""
        if self._conn is None:
            return
        pkt = np.ones(n_tx, np.float32)
        pkt[-1] = 0.0
        try:
            self._conn.sendall(pkt.astype("<f4").tobytes())
        except OSError:
            pass

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
        try:
            self._srv.close()
        except OSError:
            pass


@dataclasses.dataclass
class _ChanState:
    """Host-side per-channel NCO state (the reference block's d_* members)."""

    active: bool = False
    control_id: int = 0
    acq_doppler_hz: float = 0.0
    if_freq_hz: float = 0.0
    sample_offset: int = 0          # next epoch start within current chunk
    rem_code_phase: float = 0.0     # chips at epoch start
    code_freq: float = 0.0          # chips/s
    carrier_freq: float = 0.0       # Hz (IF + Doppler)
    carr_phase_frac: float = 0.0    # cycles in [0, 1)
    carr_phase_cycles: int = 0
    epoch_count: int = 0
    lock_fail: int = 0
    loss_of_lock: bool = False
    cn0_dbhz: float = 0.0
    carrier_lock: float = 1.0
    prompt_buf: list = dataclasses.field(default_factory=list)


class TcpTrackingEngine:
    """Host-stepped tracking engine for one signal group in TCP-connector
    mode. Drop-in producer of ``pack_host_outputs``-shaped chunk outputs."""

    CN0_EPOCHS = 20        # prompt-buffer length (reference FLAGS_cn0_samples
    #                        is 20 in the connector block's default use)

    def __init__(self, *, spec, fs: float, n_channels: int, n_steps: int,
                 n_max: int, port_ch0: int = 2060, table_rate: int = 1,
                 cn0_min_dbhz: float = 25.0, carrier_lock_min: float = 0.5,
                 max_lock_fail: int = 100):
        self.spec = spec
        self.fs = float(fs)
        self.n_steps = int(n_steps)
        self.n_max = int(n_max)
        self.table_rate = int(table_rate)
        self.taps = _VEML_TAPS if table_rate == 2 else _GPS_TAPS
        self.n_tx = 1 + 2 * len(self.taps) + 2
        self.cn0_min_dbhz = cn0_min_dbhz
        self.carrier_lock_min = carrier_lock_min
        self.max_lock_fail = max_lock_fail
        # bind every channel's listener up front (reference binds
        # port_ch0 + ch at block construction); port_ch0=0 binds ephemeral
        # ports — read .ports to learn them before connecting peers
        self.links = [TcpLoopLink(0 if port_ch0 == 0 else port_ch0 + i)
                      for i in range(n_channels)]
        self.ports = [lk.port for lk in self.links]
        self.chans = [_ChanState() for _ in range(n_channels)]
        self.code_tables = np.zeros(
            (n_channels, spec.code_length_chips * self.table_rate),
            np.float32)
        # the tables and taps on the chunk's device, uploaded again after a
        # handoff changes a table
        self._dev: dict = {}
        self.seconds = {"correlate": 0.0, "exchange": 0.0}
        self.rounds = 0          # multicorrelator calls (one per round)
        self.epochs = 0          # channel epochs exchanged with the peers

    # ------------------------------------------------------------- control
    def start_channel(self, ch: int, *, code_table: np.ndarray,
                      code_freq: float, doppler_hz: float,
                      sample_offset: int, if_freq_hz: float = 0.0) -> None:
        """Acq->trk handoff (reference ::start_tracking): blocks for the
        external peer on this channel's port if it has not connected yet."""
        self.links[ch].accept()
        self.code_tables[ch] = code_table
        self._dev.clear()
        st = self.chans[ch]
        st.active = True
        st.control_id = 0
        st.acq_doppler_hz = float(doppler_hz)
        st.if_freq_hz = float(if_freq_hz)
        st.sample_offset = int(sample_offset)
        st.rem_code_phase = 0.0
        st.code_freq = float(code_freq)
        st.carrier_freq = float(if_freq_hz + doppler_hz)
        st.carr_phase_frac = 0.0
        st.carr_phase_cycles = 0
        st.epoch_count = 0
        st.lock_fail = 0
        st.loss_of_lock = False
        st.cn0_dbhz = 0.0
        st.carrier_lock = 1.0
        st.prompt_buf = []

    def stop_channel(self, ch: int) -> None:
        self.chans[ch].active = False

    def close(self) -> None:
        for lk, st in zip(self.links, self.chans):
            if st.active:
                lk.send_terminal(self.n_tx)
            lk.close()

    # ------------------------------------------------------------ epoch op
    def _correlate(self, x: torch.Tensor, work: list) -> np.ndarray:
        """One epoch of each channel in ``work`` [(channel, n_samp)], in
        one call of the epoch multicorrelator over every channel (the others
        with no samples): the carrier wipe-off at the channel's NCO and the
        K code taps, as the scan engine's epoch_correlate (the kernel on a
        CUDA chunk, its plain version on a CPU one). Returns complex [C, K];
        only the taps cross to the host."""
        dev = x.device
        if self._dev.get("device") != dev:
            self._dev = dict(
                device=dev,
                tables=torch.from_numpy(self.code_tables).to(dev),
                taps=torch.from_numpy(self.taps).to(dev))
        n_ch = len(self.chans)
        ints = np.zeros((2, n_ch), np.int32)
        flts = np.zeros((4, n_ch), np.float32)
        for ci, n_samp in work:
            st = self.chans[ci]
            ints[:, ci] = st.sample_offset, n_samp
            flts[:, ci] = (st.rem_code_phase, st.code_freq / self.fs,
                           st.carr_phase_frac, st.carrier_freq / self.fs)
        ints_d = torch.from_numpy(ints).to(dev)
        flts_d = torch.from_numpy(flts).to(dev)
        out = correlator.batch_epoch_correlate(
            x, ints_d[0], ints_d[1], self._dev["tables"], flts_d[0],
            flts_d[1], flts_d[2], flts_d[3], self._dev["taps"],
            n_max=self.n_max, table_rate=self.table_rate).cpu().numpy()
        self.rounds += 1
        return out[..., 0] + 1j * out[..., 1]

    def _update_quality(self, st: _ChanState, prompt: complex) -> None:
        """C/N0 SNV estimator + carrier lock detector over a prompt buffer
        (reference cn0_svn_estimator / carrier_lock_detector,
        src/algorithms/tracking/libs/lock_detectors.cc)."""
        st.prompt_buf.append(prompt)
        if len(st.prompt_buf) < self.CN0_EPOCHS:
            return
        p = np.asarray(st.prompt_buf, np.complex128)
        st.prompt_buf = []
        psig = np.mean(np.abs(p.real)) ** 2
        ptot = np.mean(p.real ** 2 + p.imag ** 2)
        snr = psig / max(ptot - psig, 1e-12)
        t_int = self.spec.code_length_chips / st.code_freq
        st.cn0_dbhz = float(10.0 * np.log10(max(snr, 1e-12) / t_int))
        si, sq = p.real.sum(), p.imag.sum()
        nbp = si * si + sq * sq
        st.carrier_lock = float((si * si - sq * sq) / max(nbp, 1e-12))
        if (st.carrier_lock < self.carrier_lock_min
                or st.cn0_dbhz < self.cn0_min_dbhz):
            st.lock_fail += 1
        else:
            st.lock_fail = max(0, st.lock_fail - 1)
        if st.lock_fail > self.max_lock_fail:
            st.loss_of_lock = True

    # --------------------------------------------------------------- chunk
    def process_chunk(self, chunk, chunk_len: int):
        """Step every active channel through one conditioned chunk.

        ``chunk`` carries ``chunk_len`` samples plus the one-epoch halo the
        Receiver always appends, on the device it was uploaded to (or as
        numpy samples, correlated on the CPU). Each round correlates the
        next epoch of every channel that has one in a single call, then
        closes each of those channels' loops through its peer. Returns (f32
        [S, C, 9], i32 [S, C, 3], loss_of_lock [C]) with the exact field
        layout of ``tracking.pack_host_outputs``.
        """
        x = _as_iq2(chunk)
        s_max, n_ch = self.n_steps, len(self.chans)
        f32 = np.zeros((s_max, n_ch, 9), np.float32)
        i32 = np.zeros((s_max, n_ch, 3), np.int32)
        lol = np.zeros((n_ch,), bool)
        code_len = float(self.spec.code_length_chips)
        rows = [0] * n_ch
        while True:
            work = []
            for ci, st in enumerate(self.chans):
                if (not st.active or st.sample_offset >= chunk_len
                        or rows[ci] >= s_max):
                    continue
                cps = st.code_freq / self.fs
                n_samp = int(np.ceil((code_len - st.rem_code_phase) / cps))
                n_samp = int(np.clip(n_samp, 1, self.n_max))
                if st.sample_offset + n_samp <= x.shape[0]:
                    work.append((ci, n_samp))
            if not work:
                break
            t0 = time.perf_counter()
            corrs = self._correlate(x, work)
            t1 = time.perf_counter()
            for ci, n_samp in work:
                self._close_loop(ci, n_samp, corrs[ci], f32, i32, rows[ci])
                rows[ci] += 1
            self.seconds["correlate"] += t1 - t0
            self.seconds["exchange"] += time.perf_counter() - t1
            self.epochs += len(work)
        for ci, st in enumerate(self.chans):
            if st.active:
                st.sample_offset -= chunk_len
                lol[ci] = st.loss_of_lock
        return f32, i32, lol

    def _close_loop(self, ci: int, n_samp: int, corr: np.ndarray,
                    f32: np.ndarray, i32: np.ndarray, row: int) -> None:
        """Record channel ``ci``'s epoch at ``row``, trade its packet with
        the peer and step its NCOs through the epoch."""
        st = self.chans[ci]
        code_len = float(self.spec.code_length_chips)
        cps = st.code_freq / self.fs
        prompt = corr[-1]
        # epoch-start snapshot in pack_host_outputs field order
        f32[row, ci] = (prompt.real, prompt.imag, st.rem_code_phase,
                        st.code_freq, st.carrier_freq, st.carr_phase_frac,
                        st.cn0_dbhz, st.carrier_lock, 1.0)
        i32[row, ci] = (st.epoch_count, st.sample_offset,
                        st.carr_phase_cycles)
        # ---- TCP loop closure (reference :390-408) ----------------------
        st.control_id += 1
        tx = np.empty(self.n_tx, np.float32)
        tx[0] = st.control_id
        tx[1:1 + 2 * len(corr):2] = corr.real
        tx[2:2 + 2 * len(corr):2] = corr.imag
        tx[-2] = st.acq_doppler_hz
        tx[-1] = 1.0
        code_error, _carr_error, doppler = self.links[ci].exchange(tx)
        # ---- NCO updates (reference :408-441) ---------------------------
        # carrier: absolute Doppler command from the peer
        new_carrier = st.if_freq_hz + doppler
        # code: slew code_error chips over the next code period
        new_code_freq = 1.0 / (1.0 / self.spec.code_rate_cps
                               - code_error / code_len)
        # ---- advance phase/offset through this epoch --------------------
        total = st.carr_phase_frac + (st.carrier_freq / self.fs) * n_samp
        st.carr_phase_cycles += int(np.floor(total))
        st.carr_phase_frac = float(total - np.floor(total))
        st.rem_code_phase = st.rem_code_phase + cps * n_samp - code_len
        st.sample_offset += n_samp
        st.epoch_count += 1
        st.carrier_freq = new_carrier
        st.code_freq = new_code_freq
        self._update_quality(st, prompt)


# --------------------------------------------------------------------- peer
class LoopFilterPeer(threading.Thread):
    """Built-in external loop-filter process (the reference's MATLAB side).

    Connects to a TCP-connector channel, and for every epoch packet computes
    the discriminators and loop filters, returning
    [control_echo, code_error_chips, carr_error, carrier_doppler_hz].
    Runs an FLL-assisted pull-in for the first ``fll_epochs`` epochs, then a
    Costas PLL — the same schedule as the reference MATLAB helper scripts in
    ``src/utils/matlab/libs/gnss_sdr_tcp_connector_tracking_lib``.
    """

    def __init__(self, port: int, *, veml: bool = False,
                 code_period_s: float = 1e-3,
                 code_rate_cps: float = 1.023e6,
                 carrier_freq_hz: float = 1575.42e6,
                 pll_bw_hz: float = 25.0, dll_bw_hz: float = 2.0,
                 fll_epochs: int = 60, host: str = "127.0.0.1"):
        super().__init__(daemon=True)
        self.port, self.host = port, host
        self.veml = veml
        self.n_tx = 13 if veml else 9
        self.dt = code_period_s
        self.code_rate = code_rate_cps
        self.fc = carrier_freq_hz
        self.fll_epochs = fll_epochs
        # 2nd-order loop gains (standard 0.7-damping mapping): output is a
        # frequency correction, Hz per cycle (PLL) / chips-per-s per chip
        # (DLL) of discriminator error
        def gains(bw):
            wn = bw * 8.0 * 0.7 / (4.0 * 0.7 ** 2 + 1.0)
            return 2.0 * 0.7 * wn, wn * wn
        self.pll_kp, self.pll_ki = gains(pll_bw_hz)
        self.dll_kp, self.dll_ki = gains(dll_bw_hz)
        self.error: Exception | None = None

    def run(self) -> None:
        try:
            self._serve()
        except Exception as e:          # surfaced by tests via .error
            self.error = e

    def _serve(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=30)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        doppler = None       # carrier-loop integrator (absolute Doppler, Hz)
        dll_acc = 0.0        # code-loop integrator (code freq offset, cps)
        prev_prompt = 0j
        epoch = 0
        try:
            while True:
                pkt = np.frombuffer(
                    _recv_exact(sock, 4 * self.n_tx), "<f4")
                if pkt[-1] == 0.0:          # terminal packet
                    return
                iqs = pkt[1:-2]
                taps = iqs[0::2] + 1j * iqs[1::2]
                prompt = taps[-1]
                if doppler is None:
                    # init from the acq Doppler in every packet; with no
                    # carrier aiding in the connector NCO the code-loop
                    # integrator must hold the full code Doppler, so seed it
                    doppler = float(pkt[-2])
                    dll_acc = doppler * self.code_rate / self.fc
                # DLL: normalized non-coherent EMLP (chips) -> PI filter
                if self.veml:
                    ve, e, l, vl = taps[0], taps[1], taps[2], taps[3]
                    pe = np.hypot(abs(ve), abs(e))
                    pl = np.hypot(abs(vl), abs(l))
                    raw = (pe - pl) / max(pe + pl, 1e-12)
                else:
                    e, l = taps[0], taps[1]
                    raw = (abs(e) - abs(l)) / max(abs(e) + abs(l), 1e-12) \
                        * 0.5
                # positive EMLP (early tap stronger) = replica AHEAD of the
                # incoming code -> lower the code frequency (same polarity
                # as the scan engine: code_freq = rate + aid - code_cmd)
                code_df = dll_acc - self.dll_kp * raw       # chips/s
                dll_acc -= self.dll_ki * raw * self.dt
                # the connector NCO reads code_error as SECONDS of code
                # phase to slew over one period: 1/f' = 1/rate - e/len
                # => e = delta_f * T / rate
                code_error = code_df * self.dt / self.code_rate
                # carrier: FLL pull-in, then Costas PLL; the reply is the
                # ABSOLUTE Doppler command (reference applies it directly)
                if epoch < self.fll_epochs:
                    z = prompt * np.conj(prev_prompt)
                    if abs(prev_prompt) > 0 and abs(z.real) > 1e-12:
                        ferr = np.arctan(z.imag / z.real) \
                            / (2.0 * np.pi * self.dt)
                        doppler += 0.3 * ferr
                    carr_error, command = 0.0, doppler
                else:
                    perr = np.arctan2(
                        prompt.imag * np.sign(prompt.real),
                        abs(prompt.real)) / (2.0 * np.pi)   # cycles, Costas
                    carr_error = self.pll_kp * perr         # Hz
                    command = doppler + carr_error
                    doppler += self.pll_ki * perr * self.dt
                prev_prompt = prompt
                epoch += 1
                sock.sendall(struct.pack(
                    "<4f", pkt[0], code_error, carr_error, command))
        finally:
            sock.close()
