"""ctypes binding for the native sample-ingest library
(``gnss_sdr_tpu_torch/csrc/sampleio.cpp``).

Port of gnss_sdr_tpu/io/native.py. The library is built with ``g++ -O3``
into ``build/native/libsampleio-<hash>.so`` at the repository root (the hash
keys the source and the flags, so an edited source rebuilds) at first use,
never at import. A failed build raises: there is no silent fall back to
numpy. The numpy decoders below (``*_numpy``) are the plain versions the
tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "sampleio.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

ITEM_KINDS = {"ishort": 0, "ibyte": 1, "gr_complex": 2, "short": 3,
              "2bit_real": 4, "2bit_cpx": 5}

_lib = None
_lock = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsampleio-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is built already; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native sampleio build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native sampleio build failed:\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.reader_open.restype = ctypes.c_void_p
        lib.reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.reader_read.restype = ctypes.c_int64
        lib.reader_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p]
        lib.reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.reader_close.argtypes = [ctypes.c_void_p]
        for name in ("decode_ishort", "decode_ibyte", "decode_short",
                     "decode_2bit_packed_real", "decode_2bit_packed_cpx",
                     "decode_labsat_2bit", "decode_labsat_4bit"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_void_p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeFileSource:
    """High-rate streaming file source backed by the C++ reader.

    The C++ reader decodes the 2-bit kinds a whole byte at a time (4 real or
    2 complex samples); asked for a count that fills no whole byte it would
    write past its output. So a 2-bit read here asks for whole bytes and
    keeps the decoded remainder for the next read (the JAX package passes
    the count through and overruns its buffer on such reads)."""

    def __init__(self, path, item_type: str = "gr_complex",
                 sampling_frequency: float = 4e6):
        self._lib = get_lib()
        self._h = self._lib.reader_open(str(path).encode(),
                                        ITEM_KINDS[item_type])
        if not self._h:
            raise FileNotFoundError(path)
        self.fs = sampling_frequency
        self.item_type = item_type
        self._per = {"2bit_real": 4, "2bit_cpx": 2}.get(item_type, 1)
        self._tail = np.zeros(0, np.complex64)

    def _read_raw(self, m: int) -> np.ndarray:
        out = np.empty(m, np.complex64)
        got = self._lib.reader_read(self._h, m, _ptr(out))
        return out[:got]

    def read(self, n: int) -> np.ndarray:
        if self._per == 1:
            return self._read_raw(n)
        need = n - len(self._tail)
        x = self._tail
        if need > 0:
            m = -(-need // self._per) * self._per     # whole bytes
            x = np.concatenate([x, self._read_raw(m)])
        self._tail = x[n:]
        return x[:n]

    def seek(self, complex_sample: int) -> None:
        self._lib.reader_seek(self._h, complex_sample)
        self._tail = np.zeros(0, np.complex64)
        skip = complex_sample % self._per    # the reader seeks whole bytes
        if skip:
            self._tail = self._read_raw(self._per)[skip:]

    def close(self) -> None:
        if self._h:
            self._lib.reader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_labsat_words(raw: np.ndarray, bits_per_sample: int) -> np.ndarray:
    """Decode LabSat 2 / 3 16-bit sample words to complex64 with the native
    decoder: 2-bit, 8 samples a word; 4-bit, 4 samples a word."""
    lib = get_lib()
    words = np.ascontiguousarray(raw, np.uint16)
    per = 8 if bits_per_sample == 2 else 4
    out = np.empty(len(words) * per, np.complex64)
    fn = (lib.decode_labsat_2bit if bits_per_sample == 2
          else lib.decode_labsat_4bit)
    fn(_ptr(words), len(words), _ptr(out))
    return out


def decode_labsat_words_numpy(raw: np.ndarray,
                              bits_per_sample: int) -> np.ndarray:
    """The plain numpy version of :func:`decode_labsat_words`."""
    w = np.ascontiguousarray(raw, np.uint16).astype(np.uint32)
    if bits_per_sample == 2:
        i_bits = np.stack([(w >> (15 - 2 * i)) & 1 for i in range(8)], 1)
        q_bits = np.stack([(w >> (14 - 2 * i)) & 1 for i in range(8)], 1)
        return ((2.0 * i_bits - 1.0) + 1j * (2.0 * q_bits - 1.0)
                ).reshape(-1).astype(np.complex64)
    lut = np.array([1.0, 2.0, -2.0, -1.0], np.float32)
    ic = np.stack([(((w >> (15 - 4 * i)) & 1) << 1)
                   | ((w >> (13 - 4 * i)) & 1) for i in range(4)], 1)
    qc = np.stack([(((w >> (14 - 4 * i)) & 1) << 1)
                   | ((w >> (12 - 4 * i)) & 1) for i in range(4)], 1)
    return (lut[ic] + 1j * lut[qc]).reshape(-1).astype(np.complex64)


def decode_2bit_cpx(raw: np.ndarray) -> np.ndarray:
    """Packed 2-bit complex decode with the native decoder."""
    b = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(len(b) * 2, np.complex64)
    get_lib().decode_2bit_packed_cpx(_ptr(b), len(b), _ptr(out))
    return out


def decode_2bit_cpx_numpy(raw: np.ndarray) -> np.ndarray:
    """The plain numpy version of :func:`decode_2bit_cpx`."""
    lut = np.array([1.0, 3.0, -1.0, -3.0], np.float32)
    b = np.asarray(raw, np.uint8)
    flat = np.stack([lut[b & 3], lut[(b >> 2) & 3],
                     lut[(b >> 4) & 3], lut[(b >> 6) & 3]], axis=1).reshape(-1)
    return (flat[0::2] + 1j * flat[1::2]).astype(np.complex64)


def decode_2bit_real_numpy(raw: np.ndarray) -> np.ndarray:
    """Packed 2-bit real samples (NSR), 4 a byte LSB first: the plain
    numpy version of the native reader's ``2bit_real`` kind."""
    lut = np.array([1.0, 3.0, -1.0, -3.0], np.float32)
    b = np.asarray(raw, np.uint8)
    flat = np.stack([lut[b & 3], lut[(b >> 2) & 3],
                     lut[(b >> 4) & 3], lut[(b >> 6) & 3]], axis=1).reshape(-1)
    return flat.astype(np.complex64)
