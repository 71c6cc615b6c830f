"""``query/select.py`` of the port held against the JAX package's: the
SelectObjectContent request XML, the AWS event-stream framing with its
CRCs, and ``run_select`` over the scan (the port's ``cpu`` backend, the
JAX package's ``numpy`` one).

- ``parse_select_request``: the same fields, or the same S3 error code, on
  a hypothesis corpus of requests built from valid and invalid parts;
- ``encode_event`` byte-equal and ``iter_events`` equal on hypothesis
  headers and payloads, and a flipped byte or a truncated prelude refused;
- ``run_select``: the whole framed reply byte-equal on CSV and JSON-lines
  input, plain and GZIP, CSV and JSON output, with ``LIMIT`` and
  ``RequestProgress``, and Records split at the 1 MiB frame cap;
- the error codes of the JAX package's ``tests/test_s3_select.py``.
"""

import gzip
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from seaweedfs_tpu.query import select as jsel
from seaweedfs_tpu_torch.query import select as psel

CSV = b"id,region,score\n" + b"".join(
    b"r%d,%s,%d\n" % (i, [b"east", b"west"][i % 2], i % 100) for i in range(2000))
JSONL = b"".join(json.dumps({"a": i, "b": "xyz"[i % 3], "s": i * 1.5}).encode() + b"\n"
                 for i in range(500))


def req_xml(expression, etype="SQL", input_ser=None, output_ser="<CSV/>", extra=""):
    input_ser = input_ser if input_ser is not None else (
        "<CompressionType>NONE</CompressionType><CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>")
    return ("<SelectObjectContentRequest>"
            f"<Expression>{expression}</Expression>"
            f"<ExpressionType>{etype}</ExpressionType>"
            f"<InputSerialization>{input_ser}</InputSerialization>"
            f"<OutputSerialization>{output_ser}</OutputSerialization>{extra}"
            "</SelectObjectContentRequest>").encode()


def parsed(mod, body):
    try:
        r = mod.parse_select_request(body)
    except mod.SelectError as e:
        return ("error", e.code)
    return ("ok", {k: v for k, v in r.__dict__.items()})


EXPRS = ["SELECT * FROM s3object", "SELECT id FROM s3object WHERE score &gt; 5",
         "SELECT id, score FROM s3object WHERE region = 'east' LIMIT 3",
         "SELECT FROM WHERE", "", "SELECT s.a FROM S3Object s WHERE s.b LIKE 'x%'",
         "SELECT * FROM s3object WHERE NOT score &lt;= 3.5 OR id = 'r1'"]
INPUTS = ["<CompressionType>NONE</CompressionType><CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>",
          "<CompressionType>GZIP</CompressionType><CSV/>", "<CompressionType>BZIP2</CompressionType><CSV/>",
          "<JSON><Type>LINES</Type></JSON>", "<CSV><FileHeaderInfo>NONE</FileHeaderInfo></CSV>",
          "<CSV><FieldDelimiter>;</FieldDelimiter></CSV>", "", "<Parquet/>"]
OUTPUTS = ["<CSV/>", "<JSON/>", "<JSON><RecordDelimiter>,</RecordDelimiter></JSON>",
           "<CSV><FieldDelimiter>|</FieldDelimiter></CSV>", ""]
EXTRAS = ["", "<RequestProgress><Enabled>TRUE</Enabled></RequestProgress>",
          "<ScanRange><Start>1</Start></ScanRange>"]


@settings(max_examples=200, deadline=None)
@given(st.sampled_from(EXPRS), st.sampled_from(["SQL", "sql", "JMESPath", ""]),
       st.sampled_from(INPUTS), st.sampled_from(OUTPUTS), st.sampled_from(EXTRAS),
       st.sampled_from([None, b"<nope>", b"<SelectObjectContentRequest><Expression>",
                        b"\xff\xfe", b"<Other/>"]))
def test_parse_select_request_equal(expr, etype, inp, out, extra, raw):
    body = raw if raw is not None else req_xml(expr, etype, inp, out, extra)
    assert parsed(jsel, body) == parsed(psel, body)


header_values = st.text(max_size=20)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(st.text(min_size=1, max_size=12), header_values, max_size=4),
       st.binary(max_size=3000))
def test_encode_event_byte_equal(headers, payload):
    msg = psel.encode_event(headers, payload)
    assert msg == jsel.encode_event(headers, payload)
    (p,) = list(psel.iter_events(msg))
    (j,) = list(jsel.iter_events(msg))
    assert p == j
    assert p["payload"] == payload and p["headers"] == headers
    for i in (0, 9, len(msg) - 1):  # a flipped byte in prelude, headers or CRC
        bad = msg[:i] + bytes([msg[i] ^ 0x55]) + msg[i + 1:]
        with pytest.raises(ValueError):
            list(psel.iter_events(bad))
    with pytest.raises(ValueError):
        list(psel.iter_events(msg[:5]))


def test_event_builders_byte_equal():
    for name, args in (("records_event", (b"a,b\n",)), ("continuation_event", ()),
                       ("progress_event", (1, 2, 3)), ("stats_event", (10, 20, 5)),
                       ("end_event", ()), ("error_event", ("Code", "message"))):
        assert getattr(psel, name)(*args) == getattr(jsel, name)(*args), name


def _chunks(data, n=7):
    step = max(1, len(data) // n)
    return [data[i:i + step] for i in range(0, len(data), step)]


CASES = [
    ("csv_to_csv", CSV, req_xml("SELECT id FROM s3object WHERE region = 'east'")),
    ("csv_to_json", CSV, req_xml("SELECT id, score FROM s3object WHERE score &gt;= 98",
                                 output_ser="<JSON/>")),
    ("csv_limit_progress", CSV, req_xml("SELECT id FROM s3object LIMIT 3",
                                        extra="<RequestProgress><Enabled>true</Enabled>"
                                              "</RequestProgress>")),
    ("gzip_csv", gzip.compress(CSV), req_xml(
        "SELECT id, score FROM s3object WHERE score &gt;= 98",
        input_ser="<CompressionType>GZIP</CompressionType><CSV/>", output_ser="<JSON/>")),
    ("jsonl", JSONL, req_xml("SELECT a, s FROM s3object WHERE b = 'y'",
                             input_ser="<JSON><Type>LINES</Type></JSON>", output_ser="")),
    ("gzip_jsonl_csv_out", gzip.compress(JSONL), req_xml(
        "SELECT * FROM s3object WHERE a &lt; 20",
        input_ser="<CompressionType>GZIP</CompressionType><JSON><Type>LINES</Type></JSON>",
        output_ser="<CSV><FieldDelimiter>|</FieldDelimiter></CSV>")),
]


@pytest.mark.parametrize("name,data,body", CASES, ids=[c[0] for c in CASES])
def test_run_select_byte_equal(name, data, body):
    j = b"".join(jsel.run_select(_chunks(data), jsel.parse_select_request(body), backend="numpy"))
    p = b"".join(psel.run_select(_chunks(data), psel.parse_select_request(body), backend="cpu"))
    assert p == j
    events = list(psel.iter_events(p))
    kinds = [e["headers"][":event-type"] for e in events]
    assert kinds[-2:] == ["Stats", "End"]
    assert psel.select_to_bytes(_chunks(data), body, backend="cpu") == p


def test_records_split_at_frame_cap():
    req = psel.SelectRequest(expression="SELECT * FROM s3object", input_format="csv",
                             output_format="csv")
    row = b"x" * 4000 + b"\n"
    out = b"".join(psel.run_select(iter((b"col\n" + row * 600,)), req, backend="cpu"))
    recs = [e for e in psel.iter_events(out) if e["headers"][":event-type"] == "Records"]
    assert len(recs) >= 3 and all(len(e["payload"]) <= (1 << 20) for e in recs)
    assert b"".join(e["payload"] for e in recs) == row * 600
    jreq = jsel.SelectRequest(expression="SELECT * FROM s3object", input_format="csv",
                              output_format="csv")
    assert b"".join(jsel.run_select(iter((b"col\n" + row * 600,)), jreq, backend="numpy")) == out


def _error_code(mod, data, body, backend):
    try:
        b"".join(mod.run_select(_chunks(data), mod.parse_select_request(body), backend=backend))
    except mod.SelectError as e:
        return e.code
    return None


ERRORS = [
    ("bad_sql", CSV, req_xml("SELECT FROM WHERE"), "UnsupportedSqlStructure"),
    ("invalid_text_encoding", b"a,b\n\xff\xfe\x01,2\n", req_xml("SELECT * FROM s3object"),
     "InvalidTextEncoding"),
    ("malformed_xml", CSV, b"<nope>", "MalformedXML"),
    ("expression_type", CSV, req_xml("SELECT * FROM s3object", etype="JMESPath"),
     "InvalidExpressionType"),
    ("bad_compression", CSV, req_xml("SELECT * FROM s3object",
                                     input_ser="<CompressionType>BZIP2</CompressionType><CSV/>"),
     "InvalidCompressionFormat"),
    ("truncated_gzip", gzip.compress(CSV)[:-20], req_xml(
        "SELECT * FROM s3object", input_ser="<CompressionType>GZIP</CompressionType>"
                                            "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"),
     "InvalidCompressionFormat"),
]


@pytest.mark.parametrize("name,data,body,code", ERRORS, ids=[e[0] for e in ERRORS])
def test_error_codes(name, data, body, code):
    assert _error_code(psel, data, body, "cpu") == code
    assert _error_code(jsel, data, body, "numpy") == code
