"""FTP gateway over the filer: the port's copy of the JAX package's
``server/ftp_server.py``.

The reference shipped only an unfinished 81-line stub
(`weed/ftpd/ftp_server.go` — its AuthUser returns no filesystem, so it
never served a file). This is the finished equivalent: an RFC 959 server
(passive mode only, like the reference's intended setup) whose filesystem
is the filer, in the same role the WebDAV gateway plays. One thread per
session; PASV/EPSV data sockets on ephemeral ports.

Supported verbs: USER/PASS, SYST, FEAT, TYPE, PWD, CWD, CDUP, PASV, EPSV,
LIST, NLST, RETR, STOR, APPE, DELE, MKD, RMD, SIZE, MDTM, RNFR/RNTO,
NOOP, QUIT.
"""

from __future__ import annotations

import shutil
import socket
import threading
import time
from typing import Optional

from ..filer.client import FilerClient
from ..util import glog


def _join(cwd: str, arg: str) -> str:
    """Resolve an FTP path argument against the cwd, normalizing .. / ."""
    path = arg if arg.startswith("/") else f"{cwd.rstrip('/')}/{arg}"
    parts: list[str] = []
    for p in path.split("/"):
        if p in ("", "."):
            continue
        if p == "..":
            if parts:
                parts.pop()
            continue
        parts.append(p)
    return "/" + "/".join(parts)


# RFC 959 lines are short; 8KB leaves room for deep paths while bounding
# what a hostile newline-free stream can make the command reader buffer
_MAX_CMD_LINE = 8192


class _Session(threading.Thread):
    def __init__(self, srv: "FtpServer", conn: socket.socket, addr):
        super().__init__(daemon=True)
        self.srv = srv
        self.conn = conn
        self.addr = addr
        self.cwd = "/"  # virtual path; mapped under srv.root for the filer
        self.authed_user: Optional[str] = None
        self.pending_user = ""
        self.rename_from: Optional[str] = None
        self.type = "I"
        self._pasv: Optional[socket.socket] = None
        self._rfile = conn.makefile("rb")

    # -- plumbing ------------------------------------------------------------
    def send(self, code: int, text: str) -> None:
        self.conn.sendall(f"{code} {text}\r\n".encode())

    def send_multi(self, code: int, lines: list[str]) -> None:
        out = "".join(f"{code}-{ln}\r\n" for ln in lines[:-1])
        out += f"{code} {lines[-1]}\r\n"
        self.conn.sendall(out.encode())

    def _open_pasv(self) -> socket.socket:
        if self._pasv is not None:
            self._pasv.close()
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind((self.srv.host, 0))
        s.listen(1)
        s.settimeout(30)
        self._pasv = s
        return s

    def _data_conn(self) -> Optional[socket.socket]:
        if self._pasv is None:
            self.send(425, "Use PASV first.")
            return None
        try:
            conn, _ = self._pasv.accept()
            return conn
        except TimeoutError:
            self.send(425, "Data connection timed out.")
            return None
        finally:
            self._pasv.close()
            self._pasv = None

    def _vpath(self, arg: str) -> str:
        """Client path → normalized virtual path (.. cannot escape /)."""
        return _join(self.cwd, arg)

    def _fpath(self, arg: str) -> str:
        """Client path → filer path, confined under the gateway root."""
        v = self._vpath(arg)
        root = self.srv.root
        return v if root == "/" else (root + v).rstrip("/") or root

    def _need_auth(self) -> bool:
        if self.srv.users and self.authed_user is None:
            self.send(530, "Please login with USER and PASS.")
            return True
        return False

    # -- main loop -----------------------------------------------------------
    def run(self) -> None:
        try:
            self.send(220, "seaweedfs_tpu FTP gateway ready.")
            while True:
                # bounded: an unbounded readline() on a newline-free byte
                # stream would buffer the peer's entire output in memory
                raw = self._rfile.readline(_MAX_CMD_LINE)
                if not raw:
                    return
                if len(raw) >= _MAX_CMD_LINE and not raw.endswith(b"\n"):
                    self.send(500, "Command line too long.")
                    return  # framing is gone; drop the session
                line = raw.decode("utf-8", "replace").rstrip("\r\n")
                verb, _, arg = line.partition(" ")
                handler = getattr(self, f"do_{verb.upper()}", None)
                if handler is None:
                    self.send(502, f"Command {verb!r} not implemented.")
                    continue
                if verb.upper() not in (
                    "USER", "PASS", "QUIT", "SYST", "FEAT", "NOOP",
                ) and self._need_auth():
                    continue
                try:
                    if handler(arg):
                        return
                except Exception as e:  # noqa: BLE001 — keep session alive
                    glog.warning("ftp %s %s: %s", verb, arg, e)
                    self.send(451, "Action aborted: local error.")
        except OSError:
            pass
        finally:
            if self._pasv is not None:
                self._pasv.close()
            self.conn.close()

    # -- auth ----------------------------------------------------------------
    def do_USER(self, arg):
        self.pending_user = arg
        if not self.srv.users:
            self.authed_user = arg or "anonymous"
            self.send(230, "Login successful.")
        else:
            self.send(331, "Password required.")

    def do_PASS(self, arg):
        import hmac

        if not self.srv.users:
            self.authed_user = self.pending_user or "anonymous"
            self.send(230, "Login successful.")
            return
        # constant-time compare that runs for known AND unknown users:
        # unknown accounts compare against a dummy that can never match, so timing doesn't enumerate accounts, and a user
        # legitimately configured with an empty password still logs in
        known = (self.pending_user or "") in self.srv.users
        expect = self.srv.users.get(self.pending_user or "")
        probe = expect if known else "\x00never-matches"
        ok = hmac.compare_digest(probe, arg or "")
        if known and ok:
            self.authed_user = self.pending_user
            self.send(230, "Login successful.")
        else:
            self.send(530, "Login incorrect.")

    # -- trivia --------------------------------------------------------------
    def do_SYST(self, arg):
        self.send(215, "UNIX Type: L8")

    def do_FEAT(self, arg):
        self.send_multi(211, ["Features:", " SIZE", " MDTM", " EPSV", "End"])

    def do_NOOP(self, arg):
        self.send(200, "OK.")

    def do_TYPE(self, arg):
        self.type = arg.upper() or "I"
        self.send(200, f"Type set to {self.type}.")

    def do_QUIT(self, arg):
        self.send(221, "Goodbye.")
        return True

    # -- navigation ----------------------------------------------------------
    def do_PWD(self, arg):
        self.send(257, f'"{self.cwd}" is the current directory.')

    def do_CWD(self, arg):
        virtual = self._vpath(arg)
        target = self._fpath(arg)
        e = self.srv.client.get_entry(target)
        if virtual == "/" or (e is not None and e.get("is_directory")):
            self.cwd = virtual
            self.send(250, "Directory changed.")
        else:
            self.send(550, "No such directory.")

    def do_CDUP(self, arg):
        return self.do_CWD("..")

    # -- passive data --------------------------------------------------------
    def do_PASV(self, arg):
        s = self._open_pasv()
        h = self.srv.host.replace(".", ",")
        port = s.getsockname()[1]
        self.send(227, f"Entering Passive Mode ({h},{port >> 8},{port & 0xFF}).")

    def do_EPSV(self, arg):
        s = self._open_pasv()
        self.send(229, f"Entering Extended Passive Mode (|||{s.getsockname()[1]}|)")

    # -- listings ------------------------------------------------------------
    def _entries(self, path: str) -> list[dict]:
        return list(self.srv.client.list(path, limit=10000))

    @staticmethod
    def _ls_line(e: dict) -> str:
        kind = "d" if e.get("is_directory") else "-"
        size = e.get("size", 0) or sum(
            c.get("size", 0) for c in e.get("chunks", [])
        )
        mtime = time.strftime(
            "%b %d %H:%M", time.localtime(e.get("mtime", 0) or 0)
        )
        return (
            f"{kind}rw-r--r-- 1 weed weed {size:>12} {mtime} {e['name']}"
        )

    def _send_listing(self, arg, names_only: bool):
        path = self._fpath(arg if arg and not arg.startswith("-") else ".")
        data = self._data_conn()
        if data is None:
            return
        self.send(150, "Here comes the directory listing.")
        try:
            entries = self._entries(path)
            if names_only:
                body = "".join(e["name"] + "\r\n" for e in entries)
            else:
                body = "".join(self._ls_line(e) + "\r\n" for e in entries)
            data.sendall(body.encode())
        finally:
            data.close()
        self.send(226, "Directory send OK.")

    def do_LIST(self, arg):
        self._send_listing(arg, names_only=False)

    def do_NLST(self, arg):
        self._send_listing(arg, names_only=True)

    # -- files ---------------------------------------------------------------
    def do_RETR(self, arg):
        path = self._fpath(arg)
        e = self.srv.client.get_entry(path)
        if e is None or e.get("is_directory"):
            # filer GET on a directory answers 200 with listing JSON —
            # never serve that as file bytes
            self.send(550, "Not a plain file.")
            return
        status, body, h = self.srv.client.get_object_stream(path)
        if status != 200:
            if hasattr(body, "close"):
                body.close()
            self.send(550, "File not found.")
            return
        data = self._data_conn()
        if data is None:
            body.close()
            return
        size = h.get("Content-Length", "?")
        self.send(150, f"Opening data connection for {arg} ({size} bytes).")
        sent = 0
        try:
            # piecewise relay: downloads of any size in bounded memory
            while True:
                piece = body.read(1 << 20)
                if not piece:
                    break
                data.sendall(piece)
                sent += len(piece)
        finally:
            body.close()
            data.close()
        if size != "?" and sent != int(size):
            # a premature upstream close surfaces as EOF on read(), not an
            # exception — a truncated transfer must never be acked as 226
            self.send(451, f"Transfer aborted: got {sent} of {size} bytes.")
            return
        self.send(226, "Transfer complete.")

    def _store(self, arg, append: bool):
        path = self._fpath(arg)
        data = self._data_conn()
        if data is None:
            return
        self.send(150, "Ok to send data.")
        # FTP sends until data-socket EOF (no length up front), so spool to
        # a size-capped temp file — big uploads ride the disk, then stream
        # to the filer with a known length (bounded gateway memory)
        import tempfile

        spool = tempfile.SpooledTemporaryFile(max_size=8 * 1024 * 1024)
        try:
            if append:
                # the existing object flows into the spool in bounded
                # pieces — appending to a multi-GB file must not buffer it
                status, old, oh = self.srv.client.get_object_stream(path)
                if status == 200:
                    try:
                        shutil.copyfileobj(old, spool, 1 << 20)
                    finally:
                        old.close()
                    want = oh.get("Content-Length")
                    if want is not None and spool.tell() != int(want):
                        # upstream died mid-read: EOF, not an exception —
                        # storing the truncated prefix would be silent
                        # data loss behind a 226
                        data.close()
                        self.send(451, "Append aborted: source read truncated.")
                        return
            try:
                while True:
                    buf = data.recv(65536)
                    if not buf:
                        break
                    spool.write(buf)
            finally:
                data.close()
            size = spool.tell()
            spool.seek(0)
            self.srv.client.put_object_stream(path, spool, size)
        finally:
            spool.close()
        self.send(226, "Transfer complete.")

    def do_STOR(self, arg):
        self._store(arg, append=False)

    def do_APPE(self, arg):
        self._store(arg, append=True)

    def do_DELE(self, arg):
        path = self._fpath(arg)
        e = self.srv.client.get_entry(path)
        if e is None or e.get("is_directory"):
            self.send(550, "File not found.")  # RMD is for directories
            return
        status = self.srv.client.delete(path)
        if status >= 300:
            self.send(550, f"Delete failed ({status}).")
        else:
            self.send(250, "File deleted.")

    def do_MKD(self, arg):
        path = self._fpath(arg)
        self.srv.client.mkdir(path)
        self.send(257, f'"{arg}" created.')

    def do_RMD(self, arg):
        path = self._fpath(arg)
        e = self.srv.client.get_entry(path)
        if e is None or not e.get("is_directory"):
            self.send(550, "No such directory.")
            return
        self.srv.client.delete(path, recursive=True)
        self.send(250, "Directory removed.")

    def do_SIZE(self, arg):
        e = self.srv.client.get_entry(self._fpath(arg))
        if e is None or e.get("is_directory"):
            self.send(550, "Not a file.")
            return
        size = sum(c.get("size", 0) for c in e.get("chunks", []))
        self.send(213, str(size))

    def do_MDTM(self, arg):
        e = self.srv.client.get_entry(self._fpath(arg))
        if e is None:
            self.send(550, "Not found.")
            return
        self.send(
            213, time.strftime("%Y%m%d%H%M%S", time.gmtime(e.get("mtime", 0)))
        )

    def do_RNFR(self, arg):
        path = self._fpath(arg)
        if self.srv.client.get_entry(path) is None:
            self.send(550, "Not found.")
            return
        self.rename_from = path
        self.send(350, "Ready for RNTO.")

    def do_RNTO(self, arg):
        if self.rename_from is None:
            self.send(503, "RNFR required first.")
            return
        src, self.rename_from = self.rename_from, None
        dst = self._fpath(arg)
        # the filer has an atomic server-side rename (?mv.to=) that moves
        # files and whole directories without copying bytes
        self.srv.client.rename(src, dst)
        if self.srv.client.get_entry(dst) is None:
            self.send(550, "Rename failed.")
        else:
            self.send(250, "Rename successful.")


class FtpServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8021,
        filer_url: str = "127.0.0.1:8888",
        root: str = "/",
        users: Optional[dict[str, str]] = None,
    ):
        self.host, self.port = host, port
        self.client = FilerClient(filer_url)
        self.root = root.rstrip("/") or "/"
        self.users = users or {}  # empty → anonymous access
        self._srv: Optional[socket.socket] = None
        self._stop = threading.Event()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "FtpServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        self.port = s.getsockname()[1]
        s.listen(16)
        self._srv = s

        def loop():
            while not self._stop.is_set():
                try:
                    conn, addr = s.accept()
                except OSError:
                    return
                _Session(self, conn, addr).start()

        threading.Thread(target=loop, daemon=True).start()
        glog.info("ftp gateway on %s:%d → filer", self.host, self.port)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            self._srv.close()
