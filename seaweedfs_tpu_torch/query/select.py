"""S3 SelectObjectContent protocol: request XML + AWS event-stream framing.

The reference never finished its query path (`weed/query/sqltypes` has a
value model with no parser; `volume_grpc_query.go` is a stub), so S3
Select clients have nothing to talk to.  This module implements the wire
protocol ends of that feature:

* ``parse_select_request`` — the POST body XML (Expression +
  ExpressionType, InputSerialization for CSV / JSON-lines including
  CompressionType GZIP, OutputSerialization CSV / JSON, RequestProgress),
  validated into a :class:`SelectRequest` with AWS error codes
  (``MalformedXML``, ``InvalidExpressionType``, ``UnsupportedSqlStructure``,
  ``InvalidCompressionFormat``, ``InvalidRequest``).
* the AWS event-stream binary framing (`AWS SigV4 streaming / S3 Select
  response encoding <https://docs.aws.amazon.com/AmazonS3/latest/API/
  RESTSelectObjectAppendix.html>`_): each message is

      prelude  = total_length(u32 BE) . headers_length(u32 BE)
      message  = prelude . crc32(prelude) . headers . payload . crc32(all)

  with headers encoded as ``len(u8) name type(0x07) vlen(u16 BE) value``
  triples.  ``Records`` / ``Progress`` / ``Stats`` / ``Cont`` / ``End``
  event encoders plus ``iter_events`` (a CRC-checking decoder for tests
  and the bundled client).
* ``run_select`` — drives a compiled :class:`scan.ScanPlan` over a byte
  chunk iterator (the filer feeds ``_stream_range``'s prefetching
  generator straight in), gunzipping incrementally when asked, strictly
  validating UTF-8 (``InvalidTextEncoding``) and yielding framed events:
  one ``Records`` per scan batch (split at 1 MiB), an optional final
  ``Progress``, then ``Stats`` and ``End``.

Divergences from AWS are listed in docs/PARITY.md (SelectObjectContent
row): FileHeaderInfo is always USE, non-default CSV delimiters and
ScanRange are rejected with ``InvalidRequest``, and Progress — when
requested — is emitted once at end-of-stream rather than periodically.

The port's copy of the JAX package's ``query/select.py``.
"""

from __future__ import annotations

import codecs
import json
import struct
import xml.etree.ElementTree as ET
import zlib
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

from ..util.safe_xml import safe_fromstring
from .scan import ScanPlan
from .sql import SqlError, parse_sql

_RECORDS_FRAME = 1 << 20  # AWS caps Records payloads at 1 MiB


class SelectError(ValueError):
    """Protocol-level rejection; ``code`` is the S3 error code."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _find(el: ET.Element, tag: str) -> Optional[ET.Element]:
    for c in el.iter():
        if _strip_ns(c.tag) == tag:
            return c
    return None


def _text(el: Optional[ET.Element], default: str = "") -> str:
    if el is None or el.text is None:
        return default
    return el.text


@dataclass
class SelectRequest:
    expression: str
    select: Optional[list] = None
    where: Optional[dict] = None
    limit: int = 0
    input_format: str = "csv"  # csv | json
    compression: str = "NONE"  # NONE | GZIP
    output_format: str = "csv"  # csv | json
    output_field_delim: str = ","
    output_record_delim: str = "\n"
    progress: bool = False
    backend: Optional[str] = field(default=None)


def parse_select_request(body: bytes) -> SelectRequest:
    """SelectObjectContentRequest XML → validated SelectRequest.

    Raises SelectError with the AWS code a real S3 endpoint would return
    for each malformation class; the callers map ``code`` through the
    gateway's error table (all land on HTTP 400)."""
    try:
        root = safe_fromstring(body)
    except ET.ParseError as e:
        raise SelectError("MalformedXML", f"unparseable request: {e}") from e
    if _strip_ns(root.tag) != "SelectObjectContentRequest":
        raise SelectError(
            "MalformedXML", f"unexpected root element {root.tag!r}"
        )

    expr = _text(_find(root, "Expression")).strip()
    if not expr:
        raise SelectError("MalformedXML", "Expression is required")
    etype = _text(_find(root, "ExpressionType"), "SQL").strip() or "SQL"
    if etype.upper() != "SQL":
        raise SelectError(
            "InvalidExpressionType", f"ExpressionType {etype!r} is not SQL"
        )

    inp = _find(root, "InputSerialization")
    if inp is None:
        raise SelectError("MalformedXML", "InputSerialization is required")
    compression = _text(_find(inp, "CompressionType"), "NONE").strip() or "NONE"
    if compression.upper() not in ("NONE", "GZIP"):
        raise SelectError(
            "InvalidCompressionFormat",
            f"CompressionType {compression!r} is not supported",
        )
    in_csv = _find(inp, "CSV")
    in_json = _find(inp, "JSON")
    if in_csv is not None:
        input_format = "csv"
        header_info = _text(
            _find(in_csv, "FileHeaderInfo"), "USE"
        ).strip().upper() or "USE"
        if header_info != "USE":
            raise SelectError(
                "InvalidRequest",
                "only FileHeaderInfo=USE is supported (column names come "
                "from the first line)",
            )
        fd = _text(_find(in_csv, "FieldDelimiter"), ",") or ","
        rd = _text(_find(in_csv, "RecordDelimiter"), "\n") or "\n"
        if fd != "," or rd != "\n":
            raise SelectError(
                "InvalidRequest",
                "only the default CSV delimiters (',' fields, LF records) "
                "are supported",
            )
    elif in_json is not None:
        # Type LINES and DOCUMENT both work: the scanner sniffs a leading
        # '[' and falls back to whole-document parsing on its own
        input_format = "json"
    else:
        raise SelectError(
            "MalformedXML", "InputSerialization needs a CSV or JSON element"
        )
    if _find(root, "ScanRange") is not None:
        raise SelectError("InvalidRequest", "ScanRange is not supported")

    out = _find(root, "OutputSerialization")
    output_format, ofd, ord_ = "csv", ",", "\n"
    if out is not None:
        out_json = _find(out, "JSON")
        out_csv = _find(out, "CSV")
        if out_json is not None:
            output_format = "json"
            ord_ = _text(_find(out_json, "RecordDelimiter"), "\n") or "\n"
        elif out_csv is not None:
            ofd = _text(_find(out_csv, "FieldDelimiter"), ",") or ","
            ord_ = _text(_find(out_csv, "RecordDelimiter"), "\n") or "\n"
    elif in_json is not None:
        output_format = "json"

    rp = _find(root, "RequestProgress")
    progress = (
        rp is not None
        and _text(_find(rp, "Enabled")).strip().lower() == "true"
    )

    try:
        select, where, limit = parse_sql(expr)
    except SqlError as e:
        raise SelectError("UnsupportedSqlStructure", str(e)) from e

    return SelectRequest(
        expression=expr,
        select=select,
        where=where,
        limit=limit,
        input_format=input_format,
        compression=compression.upper(),
        output_format=output_format,
        output_field_delim=ofd,
        output_record_delim=ord_,
        progress=progress,
    )


# --------------------------------------------------------------------------
# event-stream framing
# --------------------------------------------------------------------------


def encode_event(headers: dict[str, str], payload: bytes = b"") -> bytes:
    """One event-stream message: prelude + prelude CRC + headers +
    payload + message CRC (all big-endian, CRC32 per the AWS spec)."""
    hbuf = bytearray()
    for name, value in headers.items():
        nb, vb = name.encode("utf-8"), value.encode("utf-8")
        hbuf.append(len(nb))
        hbuf += nb
        hbuf.append(0x07)  # header value type 7: string
        hbuf += struct.pack(">H", len(vb))
        hbuf += vb
    total = 12 + len(hbuf) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hbuf))
    msg = prelude + struct.pack(">I", zlib.crc32(prelude)) + hbuf + payload
    return msg + struct.pack(">I", zlib.crc32(msg))


def _event(event_type: str, content_type: str, payload: bytes) -> bytes:
    headers = {":message-type": "event", ":event-type": event_type}
    if content_type:
        headers[":content-type"] = content_type
    return encode_event(headers, payload)


def records_event(data: bytes) -> bytes:
    return _event("Records", "application/octet-stream", data)


def continuation_event() -> bytes:
    return _event("Cont", "", b"")


def _xml_counts(tag: str, scanned: int, processed: int, returned: int) -> bytes:
    return (
        f"<{tag}><BytesScanned>{scanned}</BytesScanned>"
        f"<BytesProcessed>{processed}</BytesProcessed>"
        f"<BytesReturned>{returned}</BytesReturned></{tag}>"
    ).encode("utf-8")


def progress_event(scanned: int, processed: int, returned: int) -> bytes:
    return _event(
        "Progress", "text/xml",
        _xml_counts("Progress", scanned, processed, returned),
    )


def stats_event(scanned: int, processed: int, returned: int) -> bytes:
    return _event(
        "Stats", "text/xml", _xml_counts("Stats", scanned, processed, returned)
    )


def end_event() -> bytes:
    return _event("End", "", b"")


def error_event(code: str, message: str) -> bytes:
    """Mid-stream failure frame (AWS: message-type=error, no payload)."""
    return encode_event(
        {":message-type": "error", ":error-code": code,
         ":error-message": message},
    )


def iter_events(buf: bytes) -> Iterator[dict]:
    """Decode a concatenation of event-stream messages, verifying both
    CRCs; yields {"headers": {...}, "payload": bytes}.  Raises ValueError
    on any framing damage — the test suite's oracle and the bundled
    client's parser."""
    pos = 0
    while pos < len(buf):
        if len(buf) - pos < 16:
            raise ValueError("truncated event-stream prelude")
        total, hlen = struct.unpack_from(">II", buf, pos)
        (pcrc,) = struct.unpack_from(">I", buf, pos + 8)
        if pcrc != zlib.crc32(buf[pos : pos + 8]):
            raise ValueError("prelude CRC mismatch")
        if total < 16 or pos + total > len(buf):
            raise ValueError("event length exceeds buffer")
        (mcrc,) = struct.unpack_from(">I", buf, pos + total - 4)
        if mcrc != zlib.crc32(buf[pos : pos + total - 4]):
            raise ValueError("message CRC mismatch")
        headers: dict[str, str] = {}
        hp, hend = pos + 12, pos + 12 + hlen
        if hend > pos + total - 4:
            raise ValueError("headers overrun message")
        while hp < hend:
            nlen = buf[hp]
            name = buf[hp + 1 : hp + 1 + nlen].decode("utf-8")
            hp += 1 + nlen
            vtype = buf[hp]
            if vtype != 0x07:
                raise ValueError(f"unsupported header value type {vtype}")
            (vlen,) = struct.unpack_from(">H", buf, hp + 1)
            headers[name] = buf[hp + 3 : hp + 3 + vlen].decode("utf-8")
            hp += 3 + vlen
        yield {"headers": headers, "payload": buf[hend : pos + total - 4]}
        pos += total


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------


def _gunzip_iter(chunks: Iterable[bytes]) -> Iterator[bytes]:
    # wbits=31: gzip container, incremental — a multi-chunk object is
    # never buffered compressed
    d = zlib.decompressobj(wbits=31)
    try:
        for chunk in chunks:
            got = d.decompress(chunk)
            if got:
                yield got
        tail = d.flush()
        if tail:
            yield tail
        if not d.eof:
            raise SelectError(
                "InvalidCompressionFormat", "truncated gzip stream"
            )
    except zlib.error as e:
        raise SelectError(
            "InvalidCompressionFormat", f"bad gzip data: {e}"
        ) from e


class _CountingUtf8Iter:
    """Pass-through chunk iterator that counts raw bytes and strictly
    validates UTF-8 across chunk boundaries (the scanner itself decodes
    with errors='replace'; S3 Select must reject instead)."""

    def __init__(self, chunks: Iterable[bytes]):
        self._chunks = iter(chunks)
        self._dec = codecs.getincrementaldecoder("utf-8")()
        self.nbytes = 0

    def __iter__(self):
        for chunk in self._chunks:
            self.nbytes += len(chunk)
            try:
                self._dec.decode(chunk, False)
            except UnicodeDecodeError as e:
                raise SelectError(
                    "InvalidTextEncoding",
                    f"object is not valid UTF-8 at byte "
                    f"{self.nbytes - len(chunk) + e.start}",
                ) from e
            yield chunk
        try:
            self._dec.decode(b"", True)
        except UnicodeDecodeError as e:
            raise SelectError(
                "InvalidTextEncoding",
                "object ends inside a multi-byte UTF-8 sequence",
            ) from e


def _serialize_batch(rows: list[dict], req: SelectRequest) -> bytes:
    if req.output_format == "json":
        rd = req.output_record_delim
        return "".join(json.dumps(r) + rd for r in rows).encode("utf-8")
    import csv as _csv
    import io as _io

    buf = _io.StringIO()
    w = _csv.writer(
        buf, delimiter=req.output_field_delim,
        lineterminator=req.output_record_delim,
    )
    for r in rows:
        w.writerow([
            "" if v is None
            else ("true" if v is True else "false") if isinstance(v, bool)
            else v
            for v in r.values()
        ])
    return buf.getvalue().encode("utf-8")


def run_select(
    chunks: Iterable[bytes], req: SelectRequest,
    backend: Optional[str] = None,
) -> Iterator[bytes]:
    """Drive a scan plan over a chunk stream → framed response events.

    Yields encoded event-stream messages; raises SelectError before the
    first yield for malformed input discovered up front, and mid-stream
    for damage found while scanning (callers that already sent headers
    can close with ``error_event``)."""
    plan = ScanPlan(
        select=req.select, where=req.where, limit=req.limit,
        input_format=req.input_format, backend=backend or req.backend,
    )
    raw_counter = None
    if req.compression == "GZIP":
        # BytesScanned counts raw (compressed) object bytes; UTF-8 is
        # validated on the DECOMPRESSED text, which is what the scanner
        # actually reads
        raw_counter = _RawCounter(chunks)
        text = _CountingUtf8Iter(_gunzip_iter(raw_counter))
    else:
        text = _CountingUtf8Iter(chunks)
    returned = 0
    for batch in plan.scan_iter(text):
        if not batch:
            continue
        data = _serialize_batch(batch, req)
        for off in range(0, len(data), _RECORDS_FRAME):
            frame = data[off : off + _RECORDS_FRAME]
            returned += len(frame)
            yield records_event(frame)
    scanned = raw_counter.nbytes if raw_counter is not None else text.nbytes
    processed = plan.stats["bytes_scanned"]
    if req.progress:
        yield progress_event(scanned, processed, returned)
    yield stats_event(scanned, processed, returned)
    yield end_event()


class _RawCounter:
    """Counts compressed bytes on their way into the gunzipper (the
    Stats frame's BytesScanned)."""

    def __init__(self, chunks: Iterable[bytes]):
        self._chunks = iter(chunks)
        self.nbytes = 0

    def __iter__(self):
        for chunk in self._chunks:
            self.nbytes += len(chunk)
            yield chunk


def select_to_bytes(
    chunks: Iterable[bytes], body_xml: bytes, backend: Optional[str] = None
) -> bytes:
    """Parse + run + frame in one buffered call — the filer's unit of
    work (its JSON handler replies with complete bodies)."""
    req = parse_select_request(body_xml)
    return b"".join(run_select(chunks, req, backend=backend))
