"""WebDAV gateway over the filer: the port's copy of the JAX package's
``server/webdav_server.py`` (reference: `weed/server/webdav_server.go:41`,
which adapts `golang.org/x/net/webdav` onto the filer gRPC client).

Implements the class-2 WebDAV method set — OPTIONS, PROPFIND (Depth 0/1),
PROPPATCH (dead properties persisted in the entry's extended map under
``dav-prop|``), MKCOL, GET/HEAD/PUT/DELETE, MOVE, COPY, LOCK/UNLOCK (write
locks with timeouts, depth-infinity coverage and `If:` token enforcement,
the memls analog of `golang.org/x/net/webdav` the reference relies on) —
speaking multistatus XML through the shared ``JsonHandler`` serving cores,
backed by the filer HTTP surface via FilerClient. Class 2 is what native
macOS/Windows WebDAV clients require before they will write.
"""

from __future__ import annotations

import re
import secrets
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from datetime import datetime, timezone
from ..filer.client import FilerClient
from ..util.safe_xml import safe_fromstring
from .http_util import (
    CountedReader,
    JsonHandler,
    StreamBody,
    drain_refused_body,
    start_server,
)

DAV_NS = "DAV:"

# extended-attribute key prefix for PROPPATCH'd dead properties
DEAD_PROP_PREFIX = "dav-prop|"

MAX_LOCK_TIMEOUT = 7 * 24 * 3600


@dataclass
class DavLock:
    """One active write lock (RFC 4918 §6; x/net/webdav memls analog)."""

    token: str
    path: str  # filer path it was taken on
    depth_infinity: bool
    owner_xml: str
    timeout_s: int
    expires: float = field(default=0.0)

    def refresh(self) -> None:
        self.expires = time.monotonic() + self.timeout_s

    def live(self) -> bool:
        return time.monotonic() < self.expires

    def covers(self, fp: str) -> bool:
        return fp == self.path or (
            self.depth_infinity and fp.startswith(self.path.rstrip("/") + "/")
        )


def _rfc1123(ts: float) -> str:
    return datetime.fromtimestamp(ts, tz=timezone.utc).strftime(
        "%a, %d %b %Y %H:%M:%S GMT"
    )


def _iso(ts: float) -> str:
    return datetime.fromtimestamp(ts, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def _activelock_el(lk: "DavLock", href: str) -> ET.Element:
    al = ET.Element("{DAV:}activelock")
    lt = ET.SubElement(al, "{DAV:}locktype")
    ET.SubElement(lt, "{DAV:}write")
    ls = ET.SubElement(al, "{DAV:}lockscope")
    ET.SubElement(ls, "{DAV:}exclusive")
    ET.SubElement(al, "{DAV:}depth").text = (
        "infinity" if lk.depth_infinity else "0"
    )
    if lk.owner_xml:
        try:
            al.append(ET.fromstring(lk.owner_xml))
        except ET.ParseError:
            pass
    ET.SubElement(al, "{DAV:}timeout").text = f"Second-{lk.timeout_s}"
    tok = ET.SubElement(al, "{DAV:}locktoken")
    ET.SubElement(tok, "{DAV:}href").text = lk.token
    root = ET.SubElement(al, "{DAV:}lockroot")
    ET.SubElement(root, "{DAV:}href").text = urllib.parse.quote(href)
    return al


def _propstat(href: str, entry: dict, lock: "DavLock | None" = None) -> ET.Element:
    resp = ET.Element("{DAV:}response")
    ET.SubElement(resp, "{DAV:}href").text = urllib.parse.quote(href)
    propstat = ET.SubElement(resp, "{DAV:}propstat")
    prop = ET.SubElement(propstat, "{DAV:}prop")
    is_dir = entry.get("is_directory", False)
    rtype = ET.SubElement(prop, "{DAV:}resourcetype")
    if is_dir:
        ET.SubElement(rtype, "{DAV:}collection")
    else:
        size = max(
            (c["offset"] + c["size"] for c in entry.get("chunks", [])), default=0
        )
        ET.SubElement(prop, "{DAV:}getcontentlength").text = str(size)
        ET.SubElement(prop, "{DAV:}getcontenttype").text = (
            entry.get("mime") or "application/octet-stream"
        )
        ET.SubElement(prop, "{DAV:}getetag").text = (
            '"%s"' % entry.get("extended", {}).get("md5", "")
        )
    ET.SubElement(prop, "{DAV:}getlastmodified").text = _rfc1123(
        entry.get("mtime", 0)
    )
    ET.SubElement(prop, "{DAV:}creationdate").text = _iso(entry.get("crtime", 0))
    ET.SubElement(prop, "{DAV:}displayname").text = entry.get("name", "")
    # class 2: advertise the write-lock capability + any active lock
    sl = ET.SubElement(prop, "{DAV:}supportedlock")
    le = ET.SubElement(sl, "{DAV:}lockentry")
    sc = ET.SubElement(le, "{DAV:}lockscope")
    ET.SubElement(sc, "{DAV:}exclusive")
    ty = ET.SubElement(le, "{DAV:}locktype")
    ET.SubElement(ty, "{DAV:}write")
    disc = ET.SubElement(prop, "{DAV:}lockdiscovery")
    if lock is not None:
        disc.append(_activelock_el(lock, href))
    # PROPPATCH'd dead properties ride the entry's extended map
    for k, v in (entry.get("extended") or {}).items():
        if k.startswith(DEAD_PROP_PREFIX):
            el = ET.SubElement(prop, k[len(DEAD_PROP_PREFIX):])
            el.text = v if isinstance(v, str) else str(v)
    ET.SubElement(propstat, "{DAV:}status").text = "HTTP/1.1 200 OK"
    return resp


class WebDavServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 7333,
        filer_url: str = "127.0.0.1:8888",
        root: str = "/",
        tls_cert: str = "",
        tls_key: str = "",
        tls_ca: str = "",
    ):
        self.host, self.port = host, port
        self.client = FilerClient(filer_url)
        self.root = root.rstrip("/")
        self._tls = (tls_cert, tls_key, tls_ca)
        self._srv = None
        self._locks: dict[str, DavLock] = {}  # token → lock
        self._locks_mu = threading.Lock()

    # -------------------------------------------------------------- lock table
    def _reap_locks(self) -> None:
        dead = [t for t, lk in self._locks.items() if not lk.live()]
        for t in dead:
            self._locks.pop(t, None)

    def _lock_covering(self, fp: str):
        """The live lock whose scope covers fp, if any."""
        with self._locks_mu:
            self._reap_locks()
            for lk in self._locks.values():
                if lk.covers(fp):
                    return lk
        return None

    def _lock_under(self, fp: str):
        """A live lock held on fp itself or any descendant (blocks
        depth-infinity locking / recursive ops on an ancestor)."""
        pre = fp.rstrip("/") + "/"
        with self._locks_mu:
            self._reap_locks()
            for lk in self._locks.values():
                if lk.path == fp or lk.path.startswith(pre):
                    return lk
        return None

    @staticmethod
    def _if_tokens(headers) -> list[str]:
        return re.findall(r"<(opaquelocktoken:[^>]+)>", headers.get("If", ""))

    def _locked_without_token(self, fp: str, headers) -> bool:
        """True when fp is covered by a lock whose token the request does
        not present (RFC 4918 §6.4: state-changing methods need the token)."""
        lk = self._lock_covering(fp)
        return lk is not None and lk.token not in self._if_tokens(headers)

    def _fp(self, dav_path: str) -> str:
        """DAV path → filer path under the configured root."""
        p = urllib.parse.unquote(dav_path)
        return (self.root + "/" + p.strip("/")).rstrip("/") or "/"

    # ---------------------------------------------------------------- methods
    def do_options(self, path, headers, body):
        return 200, b"", {
            "DAV": "1,2",
            "Allow": (
                "OPTIONS, PROPFIND, PROPPATCH, MKCOL, GET, HEAD, PUT, "
                "DELETE, MOVE, COPY, LOCK, UNLOCK"
            ),
            "MS-Author-Via": "DAV",
        }

    # ------------------------------------------------------------ LOCK/UNLOCK
    @staticmethod
    def _parse_timeout(headers) -> int:
        for part in headers.get("Timeout", "").split(","):
            part = part.strip()
            if part.lower().startswith("second-"):
                try:
                    return min(int(part[7:]), MAX_LOCK_TIMEOUT)
                except ValueError:
                    continue
            if part.lower() == "infinite":
                return MAX_LOCK_TIMEOUT
        return 3600  # x/net/webdav's infinite default, bounded

    @staticmethod
    def _lockdiscovery_xml(lk: DavLock, href: str) -> bytes:
        prop = ET.Element("{DAV:}prop")
        disc = ET.SubElement(prop, "{DAV:}lockdiscovery")
        disc.append(_activelock_el(lk, href))
        ET.register_namespace("D", DAV_NS)
        return b'<?xml version="1.0" encoding="utf-8"?>' + ET.tostring(prop)

    def do_lock(self, path, headers, body):
        fp = self._fp(path)
        href = "/" + path.strip("/")
        timeout_s = self._parse_timeout(headers)
        if not body.strip():
            # refresh (RFC 4918 §9.10.2): If must carry the lock's token
            lk = self._lock_covering(fp)
            if lk is None or lk.token not in self._if_tokens(headers):
                return 412, b"", {}
            lk.timeout_s = timeout_s
            lk.refresh()
            return 200, self._lockdiscovery_xml(lk, href), {
                "Content-Type": 'text/xml; charset="utf-8"',
            }
        try:
            info = safe_fromstring(body)
        except ET.ParseError:
            return 400, b"", {}
        if info.find("{DAV:}lockscope/{DAV:}exclusive") is None:
            # shared locks are not offered (same stance as most servers'
            # default deployments; exclusive is what editors use)
            return 412, b"", {}
        owner_el = info.find("{DAV:}owner")
        owner_xml = (
            ET.tostring(owner_el, encoding="unicode") if owner_el is not None else ""
        )
        depth_inf = headers.get("Depth", "infinity").lower() != "0"
        lk = DavLock(
            token="opaquelocktoken:" + secrets.token_hex(16),
            path=fp,
            depth_infinity=depth_inf,
            owner_xml=owner_xml,
            timeout_s=timeout_s,
        )
        lk.refresh()
        # conflict check + insert in ONE critical section: two concurrent
        # LOCKs must never both win an "exclusive" lock
        pre = fp.rstrip("/") + "/"
        with self._locks_mu:
            self._reap_locks()
            for other in self._locks.values():
                if other.covers(fp):
                    return 423, b"", {}
                if depth_inf and (
                    other.path == fp or other.path.startswith(pre)
                ):
                    return 423, b"", {}
            self._locks[lk.token] = lk
        created = False
        if self.client.get_entry(fp) is None:
            # lock-null: locking an unmapped URL creates an empty resource
            # (RFC 4918 §7.3, matching x/net/webdav's behavior)
            self.client.put_object(fp, b"")
            created = True
        return 201 if created else 200, self._lockdiscovery_xml(lk, href), {
            "Content-Type": 'text/xml; charset="utf-8"',
            "Lock-Token": f"<{lk.token}>",
        }

    def do_unlock(self, path, headers, body):
        fp = self._fp(path)
        m = re.search(r"<([^>]+)>", headers.get("Lock-Token", ""))
        if not m:
            return 400, b"", {}
        token = m.group(1)
        with self._locks_mu:
            self._reap_locks()
            lk = self._locks.get(token)
            if lk is None or not lk.covers(fp):
                return 409, b"", {}
            del self._locks[token]
        return 204, b"", {}

    # -------------------------------------------------------------- PROPPATCH
    def do_proppatch(self, path, headers, body):
        fp = self._fp(path)
        entry = self.client.get_entry(fp)
        if entry is None:
            return 404, b"", {}
        if self._locked_without_token(fp, headers):
            return 423, b"", {}
        try:
            update = safe_fromstring(body) if body.strip() else None
        except ET.ParseError:
            return 400, b"", {}
        extended = dict(entry.get("extended") or {})
        results: list[tuple[str, int]] = []
        if update is not None:
            for op in update:
                setting = op.tag == "{DAV:}set"
                removing = op.tag == "{DAV:}remove"
                if not (setting or removing):
                    continue
                prop = op.find("{DAV:}prop")
                for el in (prop if prop is not None else []):
                    key = DEAD_PROP_PREFIX + el.tag
                    if setting:
                        extended[key] = (el.text or "").strip()
                    else:
                        extended.pop(key, None)
                    results.append((el.tag, 200))
        entry["extended"] = extended
        self.client.create_entry(fp, entry)
        ms = ET.Element("{DAV:}multistatus")
        resp = ET.SubElement(ms, "{DAV:}response")
        ET.SubElement(resp, "{DAV:}href").text = urllib.parse.quote(
            "/" + path.strip("/")
        )
        for tag, status in results:
            ps = ET.SubElement(resp, "{DAV:}propstat")
            prop_el = ET.SubElement(ps, "{DAV:}prop")
            ET.SubElement(prop_el, tag)
            ET.SubElement(ps, "{DAV:}status").text = f"HTTP/1.1 {status} OK"
        ET.register_namespace("D", DAV_NS)
        out = b'<?xml version="1.0" encoding="utf-8"?>' + ET.tostring(ms)
        return 207, out, {"Content-Type": 'text/xml; charset="utf-8"'}

    def do_propfind(self, path, headers, body):
        depth = headers.get("Depth", "1")
        fp = self._fp(path)
        entry = self.client.get_entry(fp)
        if entry is None:
            return 404, b"", {}
        entry["name"] = fp.rsplit("/", 1)[-1]
        ms = ET.Element("{DAV:}multistatus")
        href = "/" + path.strip("/")
        if entry.get("is_directory") and not href.endswith("/"):
            href += "/"
        ms.append(_propstat(href or "/", entry, self._lock_covering(fp)))
        if depth != "0" and entry.get("is_directory"):
            for child in self.client.list(fp, limit=10000):
                chref = href.rstrip("/") + "/" + child["name"]
                cfp = fp.rstrip("/") + "/" + child["name"]
                if child.get("is_directory"):
                    chref += "/"
                ms.append(_propstat(chref, child, self._lock_covering(cfp)))
        ET.register_namespace("D", DAV_NS)
        out = b'<?xml version="1.0" encoding="utf-8"?>' + ET.tostring(ms)
        return 207, out, {"Content-Type": 'text/xml; charset="utf-8"'}

    def do_mkcol(self, path, headers, body):
        fp = self._fp(path)
        if self._locked_without_token(fp, headers):
            return 423, b"", {}
        if self.client.get_entry(fp) is not None:
            return 405, b"", {}
        parent = fp.rsplit("/", 1)[0] or "/"
        if parent != "/" and self.client.get_entry(parent) is None:
            return 409, b"", {}  # RFC: intermediate collections must exist
        self.client.mkdir(fp)
        return 201, b"", {}

    def do_get(self, path, headers, body, head=False):
        fp = self._fp(path)
        entry = self.client.get_entry(fp)
        if entry is None:
            return 404, b"", {}
        if entry.get("is_directory"):
            return 405, b"", {}
        extra = {
            "Content-Type": entry.get("mime") or "application/octet-stream",
            "Last-Modified": _rfc1123(entry.get("mtime", 0)),
            "ETag": '"%s"' % entry.get("extended", {}).get("md5", ""),
        }
        if head:
            size = max(
                (c["offset"] + c["size"] for c in entry.get("chunks", [])),
                default=0,
            )
            extra["Content-Length-Override"] = str(size)
            return 200, b"", extra
        status, data, h = self.client.get_object_stream(
            fp, rng=headers.get("Range")
        )
        if status == 206 and "Content-Range" in h:
            extra["Content-Range"] = h["Content-Range"]
        if hasattr(data, "read"):  # pass the stream through piecewise
            clen = h.get("Content-Length")
            if clen is None:  # broken upstream; never guess a length
                data.close()
                return 502, b"", {}
            extra["Content-Length-Override"] = clen
        return status, data, extra

    def do_put(self, path, headers, body):
        fp = self._fp(path)
        if self._locked_without_token(fp, headers):
            return 423, b"", {}
        existing = self.client.get_entry(fp)
        if existing is not None and existing.get("is_directory"):
            return 405, b"", {}
        # the handler always packs PUT bodies as (reader, length): stream
        # gateway→filer so a multi-GB PUT never materializes here either
        reader, length = body
        self.client.put_object_stream(
            fp, reader, length,
            content_type=headers.get("Content-Type", ""),
        )
        return 201 if existing is None else 204, b"", {}

    def do_delete(self, path, headers, body):
        fp = self._fp(path)
        if self._locked_without_token(fp, headers):
            return 423, b"", {}
        # a delete is recursive: a lock anywhere below blocks it too
        below = self._lock_under(fp)
        if below is not None and below.token not in self._if_tokens(headers):
            return 423, b"", {}
        if self.client.get_entry(fp) is None:
            return 404, b"", {}
        self.client.delete(fp, recursive=True)
        with self._locks_mu:  # locks on deleted resources die with them
            for t in [t for t, lk in self._locks.items()
                      if lk.path == fp or lk.path.startswith(fp.rstrip("/") + "/")]:
                del self._locks[t]
        return 204, b"", {}

    def _dest(self, headers) -> str | None:
        dest = headers.get("Destination", "")
        if not dest:
            return None
        return urllib.parse.urlparse(dest).path

    def do_move(self, path, headers, body):
        dest = self._dest(headers)
        if dest is None:
            return 400, b"", {}
        src_fp, dst_fp = self._fp(path), self._fp(dest)
        if self._locked_without_token(src_fp, headers) or self._locked_without_token(
            dst_fp, headers
        ):
            return 423, b"", {}
        # moving a tree disturbs everything under it: a lock held on any
        # descendant blocks the move, same as DELETE
        below = self._lock_under(src_fp)
        if below is not None and below.token not in self._if_tokens(headers):
            return 423, b"", {}
        if self.client.get_entry(src_fp) is None:
            return 404, b"", {}
        overwrite = headers.get("Overwrite", "T") != "F"
        existed = self.client.get_entry(dst_fp) is not None
        if existed and not overwrite:
            return 412, b"", {}
        if existed:
            self.client.delete(dst_fp, recursive=True)
        self.client.rename(src_fp, dst_fp)
        # RFC 4918 §7.5: locks do NOT move with the resource — locks on the
        # source subtree die, or the old URL stays 423 for up to 7 days
        src_pre = src_fp.rstrip("/") + "/"
        with self._locks_mu:
            for t in [
                t for t, lk in self._locks.items()
                if lk.path == src_fp or lk.path.startswith(src_pre)
            ]:
                del self._locks[t]
        return 204 if existed else 201, b"", {}

    def do_copy(self, path, headers, body):
        dest = self._dest(headers)
        if dest is None:
            return 400, b"", {}
        src_fp, dst_fp = self._fp(path), self._fp(dest)
        if self._locked_without_token(dst_fp, headers):
            return 423, b"", {}
        entry = self.client.get_entry(src_fp)
        if entry is None:
            return 404, b"", {}
        overwrite = headers.get("Overwrite", "T") != "F"
        existed = self.client.get_entry(dst_fp) is not None
        if existed and not overwrite:
            return 412, b"", {}
        if entry.get("is_directory"):
            self.client.mkdir(dst_fp)
            for child in self.client.list(src_fp, limit=10000):
                self.do_copy(
                    path.rstrip("/") + "/" + child["name"],
                    {
                        "Destination": dest.rstrip("/") + "/" + child["name"],
                        "Overwrite": "T",
                    },
                    b"",
                )
        else:
            # stream source→destination through the gateway: the GET body
            # feeds the PUT piecewise over two pooled sockets, so a COPY of
            # any size runs in bounded memory (and the filer overlaps its
            # own chunk uploads underneath, server/filer_server.py)
            status, data, h = self.client.get_object_stream(src_fp)
            if status != 200:
                if hasattr(data, "close"):
                    data.close()
                return 404, b"", {}
            if hasattr(data, "read"):
                clen = h.get("Content-Length")
                if clen is None:  # broken upstream; never guess a length
                    data.close()
                    return 502, b"", {}
                try:
                    self.client.put_object_stream(
                        dst_fp, data, int(clen),
                        content_type=entry.get("mime", ""),
                    )
                finally:
                    data.close()
            else:
                self.client.put_object(
                    dst_fp, data, content_type=entry.get("mime", "")
                )
        return 204 if existed else 201, b"", {}

    # --------------------------------------------------------------- lifecycle
    def start(self):
        """Serve through the shared JsonHandler infrastructure (routing,
        tolerant Content-Length parsing, streaming bodies, keep-alive and
        admission behavior) instead of a bespoke handler — the dav
        ``do_<method>(path, headers, body) → (status, payload, extra)``
        convention is adapted onto routes below."""
        dav = self

        def pieces(reader, length: int):
            """File-like upstream body → the bounded chunk iterable
            StreamBody wants (relay discipline lives in _reply_stream)."""
            left = length
            try:
                while left > 0:
                    got = reader.read(min(1 << 20, left))
                    if not got:
                        break
                    left -= len(got)
                    yield got
            finally:
                reader.close()

        def finish(h, result):
            """Map a dav (status, payload, extra) onto the JsonHandler
            reply surface: Content-Length-Override → the _reply override
            header, file-like payloads → StreamBody."""
            status, payload, extra = result
            clen = extra.pop("Content-Length-Override", None)
            if hasattr(payload, "read"):
                h.extra_headers = extra or None
                length = int(clen)
                return status, StreamBody(length, pieces(payload, length))
            if clen is not None:
                extra["Content-Length"] = clen
            h.extra_headers = extra or None
            return status, bytes(payload)

        def route(fn):
            def handle(h, path, q, body):
                headers = {k.title(): v for k, v in h.headers.items()}
                return finish(h, fn(path, headers, body))

            return handle

        @JsonHandler.mark_streaming
        def put_route(h, path, q, rfile, length):
            headers = {k.title(): v for k, v in h.headers.items()}
            reader = CountedReader(rfile, length)
            try:
                result = dav.do_put(path, headers, (reader, length))
            finally:
                if reader.left > 0:
                    # refused before the body was consumed: bounded,
                    # timeout-guarded drain keeps keep-alive framing
                    drain_refused_body(h, reader)
            return finish(h, result)

        class Handler(JsonHandler):
            server_ctx = dav
            routes = [
                ("OPTIONS", "/", route(dav.do_options)),
                ("PROPFIND", "/", route(dav.do_propfind)),
                ("MKCOL", "/", route(dav.do_mkcol)),
                ("GET", "/", route(dav.do_get)),
                ("HEAD", "/",
                 route(lambda p, hd, b: dav.do_get(p, hd, b, head=True))),
                ("PUT", "/", put_route),
                ("DELETE", "/", route(dav.do_delete)),
                ("MOVE", "/", route(dav.do_move)),
                ("COPY", "/", route(dav.do_copy)),
                ("PROPPATCH", "/", route(dav.do_proppatch)),
                ("LOCK", "/", route(dav.do_lock)),
                ("UNLOCK", "/", route(dav.do_unlock)),
            ]

            def log_message(self, fmt, *args):
                pass

            def do_OPTIONS(self):
                self._dispatch("OPTIONS")

            def do_PROPFIND(self):
                self._dispatch("PROPFIND")

            def do_MKCOL(self):
                self._dispatch("MKCOL")

            def do_MOVE(self):
                self._dispatch("MOVE")

            def do_COPY(self):
                self._dispatch("COPY")

            def do_PROPPATCH(self):
                self._dispatch("PROPPATCH")

            def do_LOCK(self):
                self._dispatch("LOCK")

            def do_UNLOCK(self):
                self._dispatch("UNLOCK")

        from ..security.tls import optional_server_context

        ctx = optional_server_context(*self._tls)
        self._srv = start_server(Handler, self.host, self.port, ssl_context=ctx)
        return self

    def stop(self):
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"
