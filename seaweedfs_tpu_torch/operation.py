"""Client operations library: assign / upload / lookup / delete / submit.

The port's copy of the JAX package's ``operation.py`` (after
`weed/operation/`: assign_file_id.go:36, upload_content.go:68, lookup.go,
delete_content.go:32, submit.go:41): the primitives the filer, the CLI's
``upload``/``download``/``delete`` and ``benchmark`` build on, over the
master and volume server HTTP surfaces. An assign with ``count=N``
reserves N consecutive needle keys under one cookie; the caller addresses
key ``i`` as ``<fid>_<i>`` (the ``fid_<delta>`` form that
``storage/file_id.py`` parses).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from .server.http_util import http_bytes, http_json
from .storage.file_id import FileId


@dataclass
class Assignment:
    fid: str
    url: str
    public_url: str
    count: int
    replicas: list[str] = field(default_factory=list)
    auth: str = ""  # the master's fid-scoped write JWT (jwt.go GenJwt)


def assign(
    master: str,
    count: int = 1,
    replication: str = "",
    collection: str = "",
    ttl: str = "",
    data_center: str = "",
) -> Assignment:
    q = f"count={count}&replication={replication}&collection={collection}&ttl={ttl}&dataCenter={data_center}"
    r = http_json("POST", f"http://{master}/dir/assign?{q}")
    if r.get("error"):
        raise RuntimeError(f"assign: {r['error']}")
    return Assignment(
        fid=r["fid"],
        url=r["url"],
        public_url=r.get("publicUrl", r["url"]),
        count=r.get("count", count),
        replicas=r.get("replicas", []),
        auth=r.get("auth", ""),
    )


def upload_data(
    url: str,
    fid: str,
    data: bytes,
    name: str = "",
    mime: str = "",
    ttl: str = "",
    jwt: str = "",
    compress: bool = True,
    is_chunk_manifest: bool = False,
) -> dict:
    # client-side auto-gzip by file type (upload_content.go:107-136); the
    # volume server stores the compressed bytes with FLAG_IS_COMPRESSED
    gzipped = False
    if compress:
        from .util import compression

        if compression.should_gzip(name, mime, data):
            gz = compression.maybe_gzip_data(data)
            if gz is not data:  # identity means it didn't pay off
                data, gzipped = gz, True

    import json

    from .server.http_util import http_bytes_headers

    q = f"?ttl={ttl}" if ttl else ""
    headers = {}
    if gzipped:
        headers["Content-Encoding"] = "gzip"
    if is_chunk_manifest:
        headers["X-Sweed-Chunk-Manifest"] = "true"
    if name:
        headers["X-Sweed-Name"] = name
    if mime:
        headers["X-Sweed-Mime"] = mime
    if jwt:
        headers["Authorization"] = f"Bearer {jwt}"
    status, body, _ = http_bytes_headers(
        "POST", f"http://{url}/{fid}{q}", body=data, timeout=60,
        headers=headers, idempotent=True,  # same fid+bytes = no-op overwrite
    )
    if status >= 300:
        raise RuntimeError(f"upload {fid}: HTTP {status} {body[:200]!r}")
    return json.loads(body or b"{}")


class LookupCache:
    """vid → locations with TTL (operation/lookup.go cache)."""

    def __init__(self, master: str, ttl_seconds: float = 600.0):
        self.master = master
        self.ttl = ttl_seconds
        self._cache: dict[int, tuple[float, list[dict]]] = {}

    def lookup(self, vid: int) -> list[dict]:
        now = time.time()
        hit = self._cache.get(vid)
        if hit and now - hit[0] < self.ttl:
            return hit[1]
        r = http_json("GET", f"http://{self.master}/dir/lookup?volumeId={vid}")
        locs = r.get("locations", [])
        if locs:
            self._cache[vid] = (now, locs)
        return locs

    def invalidate(self, vid: int) -> None:
        self._cache.pop(vid, None)


def lookup(master: str, vid: int) -> list[dict]:
    r = http_json("GET", f"http://{master}/dir/lookup?volumeId={vid}")
    return r.get("locations", [])


def range_header(byte_range: Optional[tuple[int, int]]) -> Optional[dict]:
    """The ``Range`` header asking for ``(offset, size)`` of a needle's
    bytes; None for the whole needle."""
    if byte_range is None:
        return None
    offset, size = byte_range
    return {"Range": f"bytes={offset}-{offset + size - 1}"}


def reply_bytes(status: int, body: bytes,
                byte_range: Optional[tuple[int, int]]) -> Optional[bytes]:
    """The bytes a needle GET asked for, or None when the reply lacks them:
    the whole needle from a 200; with ``(offset, size)``, exactly those
    bytes from a 206, or cut from a 200 that sent the whole needle."""
    if byte_range is None:
        return body if status == 200 else None
    offset, size = byte_range
    if status == 206 and len(body) == size:
        return body
    if status == 200 and len(body) >= offset + size:
        return body[offset:offset + size]
    return None


def download(master: str, fid: str, jwt_read_key: str = "",
             byte_range: Optional[tuple[int, int]] = None) -> bytes:
    """A needle's bytes from the first holder that serves them; with
    ``byte_range`` ``(offset, size)`` only those bytes, asked for by
    ``Range``."""
    file_id = FileId.parse(fid)
    locs = lookup(master, file_id.volume_id)
    if not locs:
        raise RuntimeError(f"volume {file_id.volume_id} not found")
    from .security import read_auth_query

    auth = read_auth_query(jwt_read_key, fid)
    last_err = None
    for loc in locs:
        status, data = http_bytes("GET", f"http://{loc['url']}/{fid}{auth}",
                                  headers=range_header(byte_range))
        got = reply_bytes(status, data, byte_range)
        if got is not None:
            return got
        last_err = f"{loc['url']}: {status}"
    raise RuntimeError(f"download {fid}: {last_err}")


def delete_file(master: str, fid: str, jwt_key: str = "") -> bool:
    file_id = FileId.parse(fid)
    locs = lookup(master, file_id.volume_id)
    auth = ""
    if jwt_key:
        # deleting clients sharing security.toml sign their own fid token
        from .security import gen_jwt

        auth = "?auth=" + gen_jwt(jwt_key, fid)
    for loc in locs:
        status, _ = http_bytes("DELETE", f"http://{loc['url']}/{fid}{auth}")
        if status < 300:
            return True
    return False


def delete_files(master: str, fids: list[str], jwt_key: str = "") -> int:
    """Grouped deletion (delete_content.go:32): fids are grouped by volume
    and each group goes to every replica location as ONE /_batch_delete
    request — the BatchDelete fan-out the reference's DeleteFiles client
    does, instead of a round-trip per fid. Returns the deleted count."""
    from collections import defaultdict

    by_vid: dict[int, list[str]] = defaultdict(list)
    for fid in fids:
        try:
            by_vid[FileId.parse(fid).volume_id].append(fid)
        # sweedlint: ok broad-except unparseable fids just don't count toward the delete set
        except Exception:  # noqa: BLE001 — an unparseable fid does not count
            pass
    deleted: set[str] = set()
    for vid, group in by_vid.items():
        locs = lookup(master, vid)
        auths = {}
        if jwt_key:
            from .security import gen_jwt

            auths = {fid: gen_jwt(jwt_key, fid) for fid in group}
        for loc in locs:
            try:
                r = http_json(
                    "POST",
                    f"http://{loc['url']}/_batch_delete",
                    {"fids": group, "auths": auths},
                )
            # sweedlint: ok broad-except one unreachable replica; the others still count
            except Exception:  # noqa: BLE001 — one unreachable replica; the others still count
                continue
            for item in r.get("results", []):
                if item.get("status") == 202:
                    deleted.add(item["fid"])
                elif item.get("status") == 409:
                    # chunk manifest: the single-fid path cascades its
                    # data-chunk deletes (delete_content.go does the same
                    # manifest special-case client-side)
                    if delete_file(master, item["fid"], jwt_key=jwt_key):
                        deleted.add(item["fid"])
    return len(deleted)


def submit(
    master: str,
    data: bytes,
    name: str = "",
    mime: str = "",
    replication: str = "",
    collection: str = "",
    ttl: str = "",
    max_mb: int = 0,
) -> str:
    """Assign + upload in one call (submit.go:41). Returns the fid.

    With max_mb > 0, files past the limit are split into chunk needles
    plus a manifest needle the volume server resolves on read
    (submit.go:115 upload_chunked_file + operation/chunked_file.go) —
    large objects without a filer in the path."""
    if max_mb > 0 and len(data) > max_mb * 1024 * 1024:
        return _submit_chunked(
            master, data, name, mime, replication, collection, ttl,
            max_mb * 1024 * 1024,
        )
    a = assign(
        master, replication=replication, collection=collection, ttl=ttl
    )
    upload_data(a.url, a.fid, data, name=name, mime=mime, ttl=ttl, jwt=a.auth)
    return a.fid


def _submit_chunked(
    master: str,
    data: bytes,
    name: str,
    mime: str,
    replication: str,
    collection: str,
    ttl: str,
    chunk_size: int,
) -> str:
    import json

    chunks = []
    try:
        for off in range(0, len(data), chunk_size):
            piece = data[off : off + chunk_size]
            a = assign(
                master, replication=replication, collection=collection,
                ttl=ttl,
            )
            # chunk bytes go up verbatim: the manifest read path
            # concatenates stored bytes, so per-chunk compression would
            # corrupt the stream
            upload_data(
                a.url, a.fid, piece, ttl=ttl, jwt=a.auth, compress=False
            )
            chunks.append({"fid": a.fid, "offset": off, "size": len(piece)})
        manifest = json.dumps(
            {"name": name, "mime": mime, "size": len(data), "chunks": chunks}
        ).encode()
        a = assign(
            master, replication=replication, collection=collection, ttl=ttl
        )
        upload_data(
            a.url, a.fid, manifest, name=name, mime=mime, ttl=ttl,
            jwt=a.auth, compress=False, is_chunk_manifest=True,
        )
        return a.fid
    except Exception:
        # no fid reaches the caller, so already-uploaded chunks would be
        # unreferenced garbage forever — sweep them (submit.go cleanup)
        if chunks:
            try:
                delete_files(master, [c["fid"] for c in chunks])
            # sweedlint: ok broad-except best-effort GC; the original upload error matters more
            except Exception:  # noqa: BLE001 — best-effort sweep; the upload error matters more
                pass
        raise
