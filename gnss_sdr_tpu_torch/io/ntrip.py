"""NTRIP v1 client transport (RTCM-over-HTTP caster protocol).

The port's copy of gnss_sdr_tpu/io/ntrip.py
(numpy host code, imports rewritten to the port's modules).

Reference analog: the NTRIP branch of RTKLIB's stream layer
(``rtklib_stream.h:67-69`` STR_NTRIPSVR/STR_NTRIPCLI and the openntrip /
readntrip helpers in rtklib_stream.cc): connect to a caster, request a
mountpoint with optional basic auth, accept the ``ICY 200 OK`` (v1) or
``HTTP/1.x 200`` (v2) response, then consume the raw RTCM byte stream.
"""

from __future__ import annotations

import base64
import socket
import threading


class NtripError(RuntimeError):
    pass


class NtripClient:
    """Streams bytes from an NTRIP caster mountpoint into a callback."""

    def __init__(self, host: str, port: int, mountpoint: str,
                 username: str | None = None, password: str | None = None,
                 user_agent: str = "NTRIP gnss_sdr_tpu/0.1"):
        self.host = host
        self.port = port
        self.mountpoint = mountpoint.lstrip("/")
        self.username = username
        self.password = password
        self.user_agent = user_agent
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _request(self) -> bytes:
        lines = [f"GET /{self.mountpoint} HTTP/1.0",
                 f"User-Agent: {self.user_agent}",
                 "Accept: */*", "Connection: close"]
        if self.username is not None:
            cred = base64.b64encode(
                f"{self.username}:{self.password or ''}".encode()).decode()
            lines.append(f"Authorization: Basic {cred}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode()

    def connect(self, timeout_s: float = 10.0) -> bytes:
        """Connect and negotiate; returns any stream bytes that arrived
        with the response header."""
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=timeout_s)
        self._sock.sendall(self._request())
        # read until end of the response header (v1 casters send a bare
        # "ICY 200 OK\r\n"; v2 send full HTTP headers ending \r\n\r\n)
        buf = b""
        while b"\r\n" not in buf:
            data = self._sock.recv(4096)
            if not data:
                raise NtripError("caster closed during negotiation")
            buf += data
        first, _, rest = buf.partition(b"\r\n")
        if first.startswith(b"ICY 200"):
            leftover = rest
        elif first.startswith(b"HTTP/") and b" 200" in first:
            while b"\r\n\r\n" not in buf:
                data = self._sock.recv(4096)
                if not data:
                    raise NtripError("caster closed during negotiation")
                buf += data
            leftover = buf.split(b"\r\n\r\n", 1)[1]
        elif first.startswith(b"SOURCETABLE"):
            raise NtripError(f"mountpoint {self.mountpoint!r} not found "
                             "(caster returned the sourcetable)")
        else:
            raise NtripError(f"caster refused: {first[:80]!r}")
        self._sock.settimeout(0.5)
        return leftover

    def stream_to(self, sink) -> None:
        """Spawn a reader thread feeding ``sink(bytes)`` until closed."""
        leftover = self.connect()
        if leftover:
            sink(leftover)

        def _reader():
            while not self._stop.is_set():
                try:
                    data = self._sock.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                sink(data)

        self._thread = threading.Thread(target=_reader, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
