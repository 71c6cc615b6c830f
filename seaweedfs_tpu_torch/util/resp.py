"""Shared RESP2 wire-format helpers: the port's copy of the JAX package's
``util/resp.py``.

One buffered reader used by both sides of the protocol: the filer's
RedisStore client (`filer/redis_store.py`) and the embedded mini server
(`util/mini_redis.py`), so framing fixes land in one place.
"""

from __future__ import annotations

from typing import Callable, Optional


class BufferedRespReader:
    """Line/exact reads over a recv callable, buffering partial frames.

    `recv` returns b"" on EOF. `read_line`/`read_exact` return None on EOF
    (server side treats that as client-gone; the client wraps it in an
    error).
    """

    def __init__(self, recv: Callable[[], bytes]):
        self._recv = recv
        self._buf = b""

    def _fill(self) -> bool:
        data = self._recv()
        if not data:
            return False
        self._buf += data
        return True

    def read_line(self) -> Optional[bytes]:
        while b"\r\n" not in self._buf:
            if not self._fill():
                return None
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> Optional[bytes]:
        while len(self._buf) < n + 2:  # payload + trailing \r\n
            if not self._fill():
                return None
        out, self._buf = self._buf[:n], self._buf[n + 2 :]
        return out

    def read_command(self) -> Optional[list[bytes]]:
        """One client→server command: RESP array of bulk strings, or an
        inline command line (redis-cli convenience)."""
        line = self.read_line()
        if line is None:
            return None
        if not line.startswith(b"*"):
            return line.split()
        args = []
        for _ in range(int(line[1:])):
            hdr = self.read_line()
            if hdr is None or not hdr.startswith(b"$"):
                return None
            arg = self.read_exact(int(hdr[1:]))
            if arg is None:
                return None
            args.append(arg)
        return args
