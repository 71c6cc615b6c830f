"""DTD-free XML parsing for untrusted bodies.

``xml.etree`` expands internal entities, so a "billion laughs" document
(nested ``<!ENTITY>`` definitions) costs exponential memory before a handler
sees one element. S3 peers never send a DTD, so a document is refused the
moment one begins: an expat pass whose ``StartDoctypeDeclHandler`` raises
runs first, before any entity is declared. Hooking the parser (not grepping
bytes) holds in any encoding and cannot mistake a comment that mentions a
DOCTYPE for one.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
import xml.parsers.expat as _expat


def _forbid_dtd(*_a, **_k):
    raise ET.ParseError("DTD/entity declarations are not accepted")


def safe_fromstring(body: bytes | str) -> ET.Element:
    raw = body.encode() if isinstance(body, str) else body
    scan = _expat.ParserCreate()
    scan.StartDoctypeDeclHandler = _forbid_dtd
    try:
        scan.Parse(raw, True)
    except ET.ParseError:
        raise  # a DTD was declared
    except _expat.ExpatError:
        pass  # malformed otherwise: ElementTree below raises its ParseError
    return ET.fromstring(raw)
