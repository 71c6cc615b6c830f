"""Minimal RESP2 (redis protocol) server for development and tests: the
port's copy of the JAX package's ``util/mini_redis.py``.

The filer's RedisStore (`filer/redis_store.py`) speaks the real redis wire
protocol; this in-process server implements the command subset the store
uses (strings + sorted sets) so the adapter can be exercised over a real
socket without an external redis. Production deployments point the store
at an actual redis/valkey — this module is the embedded stand-in, the same
role sqlite plays for the SQL store family.

Protocol: RESP2 arrays of bulk strings in, simple-string/bulk/integer/array
replies out. Commands: PING, AUTH, SELECT, ECHO, SET [EX], GET, DEL,
EXISTS, ZADD, ZREM, ZRANGE, ZRANGEBYLEX [LIMIT], ZCARD, ZSCORE, SCAN,
FLUSHDB, QUIT.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from . import glog
from .resp import BufferedRespReader


def _encode(v) -> bytes:
    """Python value → RESP2 reply bytes."""
    if v is None:
        return b"$-1\r\n"
    if isinstance(v, bool):
        return f":{int(v)}\r\n".encode()
    if isinstance(v, int):
        return f":{v}\r\n".encode()
    if isinstance(v, SimpleString):
        return b"+" + v.s.encode() + b"\r\n"
    if isinstance(v, Error):
        return b"-" + v.s.encode() + b"\r\n"
    if isinstance(v, (bytes, bytearray)):
        return b"$" + str(len(v)).encode() + b"\r\n" + bytes(v) + b"\r\n"
    if isinstance(v, str):
        return _encode(v.encode())
    if isinstance(v, (list, tuple)):
        out = b"*" + str(len(v)).encode() + b"\r\n"
        return out + b"".join(_encode(x) for x in v)
    raise TypeError(f"cannot encode {type(v)}")


class SimpleString:
    def __init__(self, s: str):
        self.s = s


class Error:
    def __init__(self, s: str):
        self.s = s


OK = SimpleString("OK")
PONG = SimpleString("PONG")


class MiniRedisServer:
    def __init__(
        self, host: str = "127.0.0.1", port: int = 0, password: str = ""
    ):
        self.host, self.port = host, port
        self.password = password
        self._strings: dict[bytes, bytes] = {}
        self._expiry: dict[bytes, float] = {}
        self._zsets: dict[bytes, dict[bytes, float]] = {}
        self._lock = threading.RLock()
        self._srv: Optional[socket.socket] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ commands
    def _expired(self, key: bytes) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and time.time() > exp:
            self._strings.pop(key, None)
            self._expiry.pop(key, None)
            return True
        return False

    def _cmd(self, args: list[bytes], state: dict):
        name = args[0].upper().decode()
        if self.password and not state.get("authed") and name not in ("AUTH", "QUIT"):
            return Error("NOAUTH Authentication required.")
        with self._lock:
            if name == "PING":
                return PONG
            if name == "ECHO":
                return args[1]
            if name == "AUTH":
                if args[-1].decode() == self.password:
                    state["authed"] = True
                    return OK
                return Error("WRONGPASS invalid username-password pair")
            if name == "SELECT":
                return OK  # single-database stand-in
            if name == "QUIT":
                state["quit"] = True
                return OK
            if name == "FLUSHDB":
                self._strings.clear()
                self._zsets.clear()
                self._expiry.clear()
                return OK
            if name == "SET":
                self._strings[args[1]] = args[2]
                self._expiry.pop(args[1], None)
                rest = [a.upper() for a in args[3:]]
                if b"EX" in rest:
                    sec = int(  # sweedlint: ok strict-int ValueError becomes an -ERR protocol reply
                        args[3 + rest.index(b"EX") + 1]
                    )
                    if sec > 0:
                        self._expiry[args[1]] = time.time() + sec
                return OK
            if name == "GET":
                if self._expired(args[1]):
                    return None
                return self._strings.get(args[1])
            if name == "DEL":
                n = 0
                for k in args[1:]:
                    n += int(self._strings.pop(k, None) is not None)
                    n += int(self._zsets.pop(k, None) is not None)
                return n
            if name == "EXISTS":
                return sum(
                    int(k in self._strings or k in self._zsets)
                    for k in args[1:]
                )
            if name == "ZADD":
                z = self._zsets.setdefault(args[1], {})
                added = 0
                for i in range(2, len(args), 2):
                    member = args[i + 1]
                    added += int(member not in z)
                    z[member] = float(args[i])  # sweedlint: ok strict-int ValueError becomes -ERR; scores may be negative/float
                return added
            if name == "ZREM":
                z = self._zsets.get(args[1], {})
                n = 0
                for m in args[2:]:
                    n += int(z.pop(m, None) is not None)
                return n
            if name == "ZCARD":
                return len(self._zsets.get(args[1], {}))
            if name == "ZSCORE":
                s = self._zsets.get(args[1], {}).get(args[2])
                return None if s is None else repr(s).encode()
            if name == "ZRANGE":
                z = self._zsets.get(args[1], {})
                members = sorted(z, key=lambda m: (z[m], m))
                start, stop = int(args[2]), int(args[3])  # sweedlint: ok strict-int ZRANGE indices are legally negative; ValueError becomes -ERR
                n = len(members)
                if start < 0:
                    start += n
                if stop < 0:
                    stop += n
                return members[max(start, 0) : stop + 1]
            if name == "ZRANGEBYLEX":
                z = self._zsets.get(args[1], {})
                members = sorted(z)
                lo, hi = args[2], args[3]

                def above(m):
                    if lo == b"-":
                        return True
                    if lo.startswith(b"("):
                        return m > lo[1:]
                    return m >= lo.lstrip(b"[")

                def below(m):
                    if hi == b"+":
                        return True
                    if hi.startswith(b"("):
                        return m < hi[1:]
                    return m <= hi.lstrip(b"[")

                out = [m for m in members if above(m) and below(m)]
                rest = [a.upper() for a in args[4:]]
                if b"LIMIT" in rest:
                    i = 4 + rest.index(b"LIMIT")
                    off, cnt = int(args[i + 1]), int(args[i + 2])  # sweedlint: ok strict-int LIMIT count -1 is legal; ValueError becomes -ERR
                    out = out[off:] if cnt < 0 else out[off : off + cnt]
                return out
            if name == "SCAN":
                # single-pass cursor: return everything at cursor 0
                keys = list(self._strings) + list(self._zsets)
                rest = [a.upper() for a in args]
                if b"MATCH" in rest:
                    import fnmatch

                    pat = args[rest.index(b"MATCH") + 1]
                    keys = [
                        k
                        for k in keys
                        if fnmatch.fnmatchcase(
                            k.decode("latin1"), pat.decode("latin1")
                        )
                    ]
                return [b"0", keys]
        return Error(f"ERR unknown command '{name}'")

    # ------------------------------------------------------------ lifecycle
    def _serve_client(self, conn: socket.socket):
        state: dict = {}
        reader = BufferedRespReader(lambda: conn.recv(65536))
        try:
            while not self._stop.is_set():
                args = reader.read_command()
                if not args:
                    return
                try:
                    reply = self._cmd(args, state)
                except Exception as e:  # noqa: BLE001 — protocol error reply
                    reply = Error(f"ERR {e}")
                conn.sendall(_encode(reply))
                if state.get("quit"):
                    return
        except OSError:
            pass
        finally:
            conn.close()

    def start(self) -> "MiniRedisServer":
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(64)

        def loop():
            while not self._stop.is_set():
                try:
                    conn, _ = self._srv.accept()
                except OSError:
                    return
                threading.Thread(
                    target=self._serve_client, args=(conn,), daemon=True
                ).start()

        threading.Thread(target=loop, daemon=True).start()
        glog.info("mini-redis on %s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv:
            self._srv.close()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"
