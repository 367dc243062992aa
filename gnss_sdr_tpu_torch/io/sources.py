"""Signal sources: sample-format decoding and chunked file/array streaming.

Port of gnss_sdr_tpu/io/sources.py (numpy host code, copied). Reference
analogs: ``File_Signal_Source`` + the data-type adapters
(``src/algorithms/signal_source/adapters/file_signal_source.cc``,
``src/algorithms/data_type_adapter/adapters/*``), the sample-count valve
(``gnss_sdr_valve``), the LabSat 2 / 3 and SPIR capture formats, the
antenna-array file, and the UDP and rtl_tcp network sources. Conversion to
complex64 happens on the host at ingest (numpy, or the native decoders of
``io/native.py``); conditioning happens on the receiver's device.
"""

from __future__ import annotations

import pathlib

import numpy as np

ITEM_TYPES = {
    # name: (numpy dtype, components per complex sample)
    "gr_complex": (np.complex64, 1),
    "ishort": (np.int16, 2),
    "ibyte": (np.int8, 2),
    "cshort": (np.int16, 2),
    "cbyte": (np.int8, 2),
    "short": (np.int16, 1),
    "byte": (np.int8, 1),
    "float": (np.float32, 1),
}


def decode_samples(raw: np.ndarray, item_type: str) -> np.ndarray:
    """Convert raw file samples to complex64 baseband."""
    if item_type == "gr_complex":
        return raw.astype(np.complex64)
    dtype, comps = ITEM_TYPES[item_type]
    if comps == 2:
        f = raw.astype(np.float32)
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    return raw.astype(np.float32).astype(np.complex64)


class FileSignalSource:
    """Chunked reader for raw IQ capture files (all reference item types)."""

    def __init__(self, path: str | pathlib.Path, item_type: str = "gr_complex",
                 sampling_frequency: float = 4e6, samples: int = 0,
                 repeat: bool = False):
        if item_type not in ITEM_TYPES:
            raise ValueError(f"unknown item_type {item_type!r}")
        self.path = pathlib.Path(path)
        self.item_type = item_type
        self.fs = sampling_frequency
        self.repeat = repeat
        dtype, comps = ITEM_TYPES[item_type]
        self._dtype, self._comps = dtype, comps
        n_raw = self.path.stat().st_size // np.dtype(dtype).itemsize
        self.total_samples = n_raw // comps
        if samples > 0:
            self.total_samples = min(self.total_samples, samples)  # valve
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        """Read up to n complex samples (fewer at EOF unless repeating)."""
        out = []
        remaining = n
        while remaining > 0:
            avail = self.total_samples - self._pos
            if avail <= 0:
                if not self.repeat:
                    break
                self._pos = 0
                avail = self.total_samples
            take = min(remaining, avail)
            raw = np.fromfile(self.path, dtype=self._dtype,
                              count=take * self._comps,
                              offset=self._pos * self._comps
                              * np.dtype(self._dtype).itemsize)
            out.append(decode_samples(raw, self.item_type))
            self._pos += take
            remaining -= take
        if not out:
            return np.zeros(0, np.complex64)
        return np.concatenate(out) if len(out) > 1 else out[0]


class ArraySignalSource:
    """In-memory source (tests / signal generator)."""

    def __init__(self, samples: np.ndarray, sampling_frequency: float):
        self.samples = np.asarray(samples, np.complex64)
        self.fs = sampling_frequency
        self.total_samples = len(self.samples)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        take = self.samples[self._pos: self._pos + n]
        self._pos += len(take)
        return take


class LabsatSignalSource:
    """LabSat 2 / LabSat 3 capture-file source.

    Reference analog: ``labsat23_source`` (``src/algorithms/signal_source/
    gnuradio_blocks/labsat23_source.cc``): parses the LS2/LS3 header
    (8-byte zero preamble, 'LS2'/'LS3' magic, sub-version, little-endian
    header length, section 2 with ref clock / bits-per-sample / channel
    layout), then streams 16-bit sample words (2-bit: 8 complex samples per
    word; 4-bit sign/magnitude: 4 per word) through the native decoder.
    LabSat 3 captures are file sequences ``<base>_0000.LS3, _0001.LS3, ...``
    consumed transparently.
    """

    def __init__(self, path: str | pathlib.Path, channel: int = 1,
                 sampling_frequency: float = 16.368e6):
        self.base = str(path)
        self.fs = sampling_frequency
        self.channel = channel
        self._file_no = 0
        self._f = open(self._filename(), "rb")
        self._parse_header()
        self.total_samples = -1          # streaming; unknown up front
        self._tail = np.zeros(0, np.complex64)

    def _filename(self) -> str:
        if self.base.lower().endswith(".ls2"):
            if self._file_no == 0:
                return self.base
            raise FileNotFoundError("LS2 captures are single-file")
        return f"{self.base}_{self._file_no:04d}.LS3"

    def _parse_header(self) -> None:
        head = self._f.read(1024)
        if len(head) < 64 or head[:8] != b"\x00" * 8:
            raise ValueError("LabSat preamble not found")
        magic = head[8:11]
        if magic == b"LS2":
            self.version = 2
        elif magic == b"LS3":
            self.version = 3
        else:
            raise ValueError(f"unknown LabSat magic {magic!r}")
        self.sub_version = head[11]
        header_bytes = int.from_bytes(head[12:16], "little")
        p = 16
        # first section must be id 2 (record parameters)
        section_id = int.from_bytes(head[p: p + 2], "little")
        p += 6                             # id (2) + section length (4)
        if section_id != 2:
            raise ValueError("LabSat header section 2 missing")
        self.ref_clock = head[p]; p += 1
        self.bits_per_sample = head[p]; p += 1
        if self.bits_per_sample not in (2, 4):
            raise ValueError(
                f"unsupported LabSat bits/sample {self.bits_per_sample}")
        self.channel_layout = head[p]; p += 1
        # order matters: the config-inconsistency error (channel 2 requested
        # from a single-channel file) must be reachable — the reference
        # reports the same two cases in this order (labsat23_source.cc:340,
        # :346 "todo: Add support for dual channel")
        if self.channel == 2 and self.channel_layout != 0:
            raise ValueError("channel 2 requested but file is single-channel")
        if self.channel_layout == 0:
            raise ValueError(
                "dual-channel LabSat files not supported (the reference "
                "labsat23_source has the same limitation)")
        self.quantization = head[p]; p += 1
        self.constellation_a = head[p]; p += 1
        self.constellation_b = head[p]; p += 1
        self._f.seek(header_bytes)

    @property
    def samples_per_word(self) -> int:
        return 8 if self.bits_per_sample == 2 else 4

    def read(self, n: int) -> np.ndarray:
        from gnss_sdr_tpu_torch.io import native
        per = self.samples_per_word
        # decoded-but-unreturned samples of the last word from the previous
        # read(): words decode whole, so an unaligned n must not discard the
        # remainder (the file position has already advanced past it)
        out: list[np.ndarray] = [self._tail] if len(self._tail) else []
        have = len(self._tail)
        need_words = -(-(n - have) // per) if n > have else 0
        while need_words > 0:
            raw = np.fromfile(self._f, dtype="<u2", count=need_words)
            if len(raw):
                out.append(native.decode_labsat_words(
                    raw, self.bits_per_sample))
                need_words -= len(raw)
                continue
            # next file in an LS3 sequence, if any
            self._file_no += 1
            try:
                nxt = open(self._filename(), "rb")
            except (FileNotFoundError, OSError):
                break
            self._f.close()
            self._f = nxt                  # data files have no header
        if not out:
            return np.zeros(0, np.complex64)
        x = np.concatenate(out) if len(out) > 1 else out[0]
        self._tail = x[n:]
        return x[:n]

    def close(self) -> None:
        self._f.close()


def labsat_header(bits_per_sample: int, version: int = 3,
                  header_bytes: int = 64) -> bytes:
    """A single-channel LabSat 2 / 3 header as :class:`LabsatSignalSource`
    parses it: zero preamble, 'LS2' / 'LS3', section 2 with the bits per
    sample, channel A only (GPS)."""
    head = bytearray(header_bytes)
    head[8:11] = b"LS3" if version == 3 else b"LS2"
    head[11] = 1                                  # sub version
    head[12:16] = int(header_bytes).to_bytes(4, "little")
    head[16:18] = (2).to_bytes(2, "little")       # section id 2
    head[18:22] = (16).to_bytes(4, "little")      # section length
    head[23] = bits_per_sample
    head[24] = 1                                  # channel A only
    head[25] = 1                                  # quantization
    head[27] = 255                                # no channel B
    return bytes(head)


def encode_labsat_words(x: np.ndarray, bits_per_sample: int,
                        threshold: float | None = None) -> np.ndarray:
    """complex samples -> LabSat 16-bit words, the inverse of the decoders
    of ``io/native.py``: 2-bit keeps each component's sign (8 samples a
    word); 4-bit sign / magnitude (4 a word) codes |v| > ``threshold``
    (default: the components' rms) as 2, else 1. ``len(x)`` must fill
    whole words."""
    per = 8 if bits_per_sample == 2 else 4
    x = np.asarray(x, np.complex64).reshape(-1, per)
    comps = (x.real, x.imag)
    w = np.zeros(len(x), np.uint32)
    if bits_per_sample == 2:
        for i in range(per):
            for c, v in enumerate(comps):
                w |= (v[:, i] > 0).astype(np.uint32) << (15 - c - 2 * i)
        return w.astype(np.uint16)
    if threshold is None:
        threshold = float(np.sqrt(np.mean(np.abs(x) ** 2) / 2.0))
    for i in range(per):
        for c, v in enumerate(comps):
            neg = (v[:, i] < 0).astype(np.uint32)
            mag = (np.abs(v[:, i]) > threshold).astype(np.uint32) ^ neg
            w |= (neg << (15 - c - 4 * i)) | (mag << (13 - c - 4 * i))
    return w.astype(np.uint16)


def decode_spir_int1(raw_int32: np.ndarray, channel: int = 1) -> np.ndarray:
    """SPIR 1-bit int format: one int32 per complex sample; the selected
    channel's I bit is (val >> ((ch-1)*2)) & 1, Q bit is (val >> (2ch-1))
    & 1, mapped to +/-32767 (reference unpack_intspir_1bit_samples.cc)."""
    v = np.asarray(raw_int32).astype(np.int64)
    i_bits = (v >> ((channel - 1) * 2)) & 1
    q_bits = (v >> (2 * channel - 1)) & 1
    amp = np.float32(32767.0)
    return ((2 * i_bits - 1) * amp
            + 1j * ((2 * q_bits - 1) * amp)).astype(np.complex64)


def decode_spir_gss6450(raw_int32: np.ndarray, adc_bits: int) -> np.ndarray:
    """SPIR GSS6450 packing: int32 words holding 8 (2-bit ADC) or 4 (4-bit)
    complex samples, I then Q LSB-first per sample, two's-complement, with
    samples emitted in REVERSED order within the word
    (reference unpack_spir_gss6450_samples.cc decode_4bits_word)."""
    if adc_bits not in (2, 4):
        raise ValueError(f"unsupported GSS6450 adc_bits {adc_bits}")
    w = np.asarray(raw_int32).astype(np.uint32)
    per = 16 // adc_bits
    mask = (1 << adc_bits) - 1
    half = 1 << (adc_bits - 1)
    full = 1 << adc_bits
    comps = []
    for k in range(per):
        i_raw = (w >> (2 * adc_bits * k)) & mask
        q_raw = (w >> (2 * adc_bits * k + adc_bits)) & mask
        i_val = np.where(i_raw >= half, i_raw.astype(np.int64) - full, i_raw)
        q_val = np.where(q_raw >= half, q_raw.astype(np.int64) - full, q_raw)
        comps.append(i_val + 1j * q_val)
    # extraction k fills output slot per-1-k (reversed within the word)
    out = np.stack(comps[::-1], axis=1)
    return out.reshape(-1).astype(np.complex64)


class SpirSignalSource:
    """SPIR capture-file source (1-bit int or GSS6450 packed formats).

    Reference analogs: ``Spir_File_Signal_Source`` and
    ``Spir_GSS6450_File_Signal_Source`` adapters with their unpack blocks.
    ``fmt``: "int1" (one int32 per sample, channel-selectable) or
    "gss6450" with ``adc_bits`` in {2, 4}.
    """

    def __init__(self, path: str | pathlib.Path, fmt: str = "int1",
                 sampling_frequency: float = 80e6, channel: int = 1,
                 adc_bits: int = 4, samples: int = 0):
        self.path = pathlib.Path(path)
        self.fmt = fmt
        self.fs = sampling_frequency
        self.channel = channel
        self.adc_bits = adc_bits
        words = self.path.stat().st_size // 4
        self.samples_per_word = (1 if fmt == "int1" else 16 // adc_bits)
        self.total_samples = words * self.samples_per_word
        if samples > 0:
            self.total_samples = min(self.total_samples, samples)
        self._pos = 0          # in samples

    def read(self, n: int) -> np.ndarray:
        per = self.samples_per_word
        take = min(n, self.total_samples - self._pos)
        if take <= 0:
            return np.zeros(0, np.complex64)
        w0 = self._pos // per
        w1 = -(-(self._pos + take) // per)
        raw = np.fromfile(self.path, dtype="<i4", count=w1 - w0,
                          offset=4 * w0)
        if self.fmt == "int1":
            x = decode_spir_int1(raw, self.channel)
        else:
            x = decode_spir_gss6450(raw, self.adc_bits)
        x = x[self._pos - w0 * per: self._pos - w0 * per + take]
        self._pos += take
        return x


class ArrayFileSignalSource:
    """N-element antenna-array capture file: element-interleaved samples
    (t0e0, t0e1, ..., t0eN-1, t1e0, ...). ``read(n)`` returns an [N, n]
    complex block for the beamformer conditioner.

    Reference analog: Raw_Array_Signal_Source feeding the
    Array_Signal_Conditioner (``src/algorithms/conditioner/adapters/
    array_signal_conditioner.cc``) ahead of Beamformer_Filter.
    """

    def __init__(self, path: str | pathlib.Path, n_elements: int = 4,
                 item_type: str = "gr_complex",
                 sampling_frequency: float = 4e6, samples: int = 0):
        if item_type not in ITEM_TYPES:
            raise ValueError(f"unknown item_type {item_type!r}")
        self.path = pathlib.Path(path)
        self.n_elements = n_elements
        self.item_type = item_type
        self.fs = sampling_frequency
        dtype, comps = ITEM_TYPES[item_type]
        self._dtype, self._comps = dtype, comps
        n_raw = self.path.stat().st_size // np.dtype(dtype).itemsize
        self.total_samples = n_raw // comps // n_elements
        if samples > 0:
            self.total_samples = min(self.total_samples, samples)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        take = min(n, self.total_samples - self._pos)
        if take <= 0:
            return np.zeros((self.n_elements, 0), np.complex64)
        count = take * self.n_elements * self._comps
        offset = (self._pos * self.n_elements * self._comps
                  * np.dtype(self._dtype).itemsize)
        raw = np.fromfile(self.path, dtype=self._dtype, count=count,
                          offset=offset)
        x = decode_samples(raw, self.item_type)
        self._pos += take
        # element-interleaved -> [N, T]
        return np.ascontiguousarray(
            x.reshape(take, self.n_elements).T)


class UdpSignalSource:
    """Raw IQ over UDP datagrams (reference: Custom_UDP_Signal_Source,
    custom_udp_signal_source.cc — libpcap there, a plain UDP socket here).

    Each datagram carries consecutive samples of ``item_type``; datagrams are
    assumed in-order (LAN use). ``read`` blocks until n samples or timeout.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 1234,
                 item_type: str = "ishort", sampling_frequency: float = 4e6,
                 timeout_s: float = 2.0):
        import socket
        if item_type not in ITEM_TYPES:
            raise ValueError(f"unknown item_type {item_type!r}")
        self.item_type = item_type
        self.fs = sampling_frequency
        self._dtype, self._comps = ITEM_TYPES[item_type]
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(timeout_s)
        self.port = self._sock.getsockname()[1]
        self._buf = b""

    def read(self, n: int) -> np.ndarray:
        import socket
        item = np.dtype(self._dtype).itemsize
        need = n * self._comps * item
        while len(self._buf) < need:
            try:
                pkt = self._sock.recv(65536)
            except socket.timeout:
                break
            if not pkt:
                break
            self._buf += pkt
        take = (len(self._buf) // (self._comps * item)) * self._comps * item
        take = min(take, need)
        raw = np.frombuffer(self._buf[:take], dtype=self._dtype)
        self._buf = self._buf[take:]
        return decode_samples(raw, self.item_type)

    def close(self) -> None:
        self._sock.close()


class RtlTcpSignalSource:
    """rtl_tcp client (reference: RtlTcp_Signal_Source, rtl_tcp_*.cc).

    Connects to an rtl_tcp server, configures frequency/rate/gain with the
    standard 5-byte command packets, and streams unsigned-8-bit interleaved
    IQ (converted to complex64 centered on zero).
    """

    CMD_FREQ = 0x01
    CMD_RATE = 0x02
    CMD_GAIN_MODE = 0x03
    CMD_AGC = 0x08

    def __init__(self, host: str = "127.0.0.1", port: int = 1234,
                 frequency_hz: float = 1_575_420_000.0,
                 sampling_frequency: float = 2_000_000.0,
                 agc: bool = True, timeout_s: float = 5.0):
        import socket
        import struct
        self.fs = sampling_frequency
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        header = self._recv_exact(12)       # "RTL0" + tuner type/gain count
        if header[:4] not in (b"RTL0", b""):
            pass                            # tolerate nonstandard servers
        for cmd, val in ((self.CMD_RATE, int(sampling_frequency)),
                         (self.CMD_FREQ, int(frequency_hz)),
                         (self.CMD_AGC, 1 if agc else 0)):
            self._sock.sendall(struct.pack(">BI", cmd, val))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                break
            buf += chunk
        return buf

    def read(self, n: int) -> np.ndarray:
        raw = self._recv_exact(2 * n)
        u = np.frombuffer(raw, np.uint8).astype(np.float32)
        u = (u - 127.4) / 128.0
        m = (len(u) // 2) * 2
        return (u[0:m:2] + 1j * u[1:m:2]).astype(np.complex64)

    def close(self) -> None:
        self._sock.close()
