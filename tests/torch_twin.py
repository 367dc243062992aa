"""Shared helpers of the port's PVT tests (tests/test_torch_{rtcm,rtk,ppp,
outputs}.py).

Not a test module. The port's host modules are copies of the JAX
package's, so each test builds its inputs once, from a seed with numpy
and the JAX package's modules, hands each package its own twin of every
input object (:func:`twin`), runs both and holds the results equal with
:func:`assert_same`: floats bit for bit, integers, flags and strings
exactly. :class:`Caster` is a local RTCM base for the NTRIP / TCP tests.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import socket
import threading
import types

import numpy as np

ROOTS = {"jax": "gnss_sdr_tpu", "port": "gnss_sdr_tpu_torch"}
TAGS = tuple(ROOTS)


def modules(tag: str, **paths: str) -> types.SimpleNamespace:
    """``name=dotted.path`` pairs imported from one package's root."""
    root = ROOTS[tag]
    return types.SimpleNamespace(**{
        name: importlib.import_module(f"{root}.{path}")
        for name, path in paths.items()})


def _twin_class(cls, tag: str):
    mod = cls.__module__
    if tag == "jax" or not mod.startswith("gnss_sdr_tpu."):
        return cls
    port_mod = importlib.import_module(
        mod.replace("gnss_sdr_tpu", "gnss_sdr_tpu_torch", 1))
    return getattr(port_mod, cls.__qualname__)


def twin(obj, tag: str):
    """``obj`` (built with the JAX package's classes) as ``tag``'s package
    holds it: each JAX dataclass becomes the port's class of the same name
    with the same field values (attributes set after construction too),
    containers are rebuilt, arrays copied; anything else is shared."""
    if tag == "jax":
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _twin_class(type(obj), tag)
        init = {f.name for f in dataclasses.fields(obj) if f.init}
        state = {k: twin(v, tag) for k, v in vars(obj).items()}
        out = cls(**{k: v for k, v in state.items() if k in init})
        for k, v in state.items():
            if k not in init:
                setattr(out, k, v)
        return out
    if isinstance(obj, dict):
        return {k: twin(v, tag) for k, v in obj.items()}
    if isinstance(obj, list):
        return [twin(v, tag) for v in obj]
    if isinstance(obj, tuple):
        return tuple(twin(v, tag) for v in obj)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    return obj


_DATA = (bool, int, float, str, bytes, type(None), np.ndarray, np.generic,
         dict, list, tuple)


def state(obj, depth: int = 2) -> dict:
    """An object's data attributes: numbers, strings, arrays, containers and
    dataclasses as they are, nested objects of either package down to
    ``depth`` levels; locks, threads, sockets and callables left out."""
    out = {}
    for k, v in vars(obj).items():
        if isinstance(v, _DATA) or (dataclasses.is_dataclass(v)
                                    and not isinstance(v, type)):
            out[k] = v
        elif (depth > 0 and not callable(v) and hasattr(v, "__dict__")
              and type(v).__module__.split(".")[0] in ROOTS.values()):
            out[k] = state(v, depth - 1)
    return out


def assert_same(a, b, where: str = "result") -> None:
    """``a`` (JAX) and ``b`` (the port) hold the same values: arrays of one
    dtype and shape, bit-equal (NaN where NaN); floats bit-equal; dataclass
    instances of the same class name with the same attributes."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__qualname__ == type(b).__qualname__, where
        va, vb = vars(a), vars(b)
        assert sorted(va) == sorted(vb), where
        for k in va:
            assert_same(va[k], vb[k], f"{where}.{k}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{k}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), where
        assert (math.isnan(a) and math.isnan(b)) or a == b, (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


class Caster:
    """A local RTCM base on 127.0.0.1 (port 0) for any number of clients.
    With ``ntrip`` it reads each request and answers ``ICY 200 OK`` and
    ``payload`` when the request names ``mount`` (any mountpoint when
    ``mount`` is None), else the sourcetable; without it, it sends
    ``payload`` on connecting. Connections stay open until :meth:`close`,
    which joins the thread (5 s) and closes every socket."""

    def __init__(self, ntrip: bool = True, mount: str | None = None,
                 payload: bytes = b""):
        self.ntrip, self.mount, self.payload = ntrip, mount, payload
        self.requests: list[bytes] = []
        self._conns: list = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self._srv.settimeout(0.1)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(5.0)
            self._conns.append(conn)
            if not self.ntrip:
                conn.sendall(self.payload)
                continue
            req = b""
            while b"\r\n\r\n" not in req:
                req += conn.recv(4096)
            self.requests.append(req)
            if self.mount is None or f"GET /{self.mount} ".encode() in req:
                conn.sendall(b"ICY 200 OK\r\n" + self.payload)
            else:
                conn.sendall(b"SOURCETABLE 200 OK\r\n\r\n")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        for c in self._conns:
            c.close()
        self._srv.close()
        assert not self._thread.is_alive()
