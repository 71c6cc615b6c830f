"""Minimal XML (de)serialization for the S3 wire protocol."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any

from ..util.safe_xml import safe_fromstring

S3_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _build(parent: ET.Element, value: Any) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(v, list):
                for item in v:
                    _build(ET.SubElement(parent, k), item)
            else:
                _build(ET.SubElement(parent, k), v)
    elif isinstance(value, bool):
        parent.text = "true" if value else "false"
    elif value is None:
        parent.text = ""
    else:
        parent.text = str(value)


def to_xml(root_tag: str, value: Any, xmlns: str = S3_XMLNS) -> bytes:
    root = ET.Element(root_tag)
    if xmlns:
        root.set("xmlns", xmlns)
    _build(root, value)
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_xml(body: bytes) -> ET.Element:
    return safe_fromstring(body)


def find_text(el: ET.Element, tag: str, default: str = "") -> str:
    for c in el.iter():
        if strip_ns(c.tag) == tag:
            return c.text or default
    return default
