"""Embedded status pages: the `weed/server/*_ui` analog.

The port of the JAX package's ``server/status_ui.py``. The reference packs
HTML templates (master_ui/, volume_server_ui/) via statik; here one shared
renderer turns a daemon's status dicts into a self-contained page (no
assets, no scripts), served at ``GET /ui`` by the volume server and the
master.
"""

from __future__ import annotations

import html
from typing import Any

_STYLE = """
body{font-family:system-ui,sans-serif;margin:2em;color:#222}
h1{font-size:1.3em;border-bottom:2px solid #3a6;padding-bottom:.2em}
h2{font-size:1.05em;margin-top:1.4em;color:#3a6}
table{border-collapse:collapse;margin:.5em 0;min-width:24em}
td,th{border:1px solid #ccc;padding:.25em .6em;text-align:left;font-size:.9em}
th{background:#f4f7f5}
code{background:#f2f2f2;padding:0 .3em}
.kv td:first-child{font-weight:600;background:#fafafa}
"""


def _render_value(v: Any) -> str:
    if isinstance(v, dict):
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td><td>{_render_value(x)}</td></tr>"
            for k, x in v.items()
        )
        return f'<table class="kv">{rows}</table>'
    if isinstance(v, list):
        if v and all(isinstance(x, dict) for x in v):
            cols = sorted({k for x in v for k in x})
            head = "".join(f"<th>{html.escape(str(c))}</th>" for c in cols)
            body = "".join(
                "<tr>"
                + "".join(f"<td>{_render_value(x.get(c, ''))}</td>" for c in cols)
                + "</tr>"
                for x in v
            )
            return f"<table><tr>{head}</tr>{body}</table>"
        return html.escape(", ".join(str(x) for x in v)) or "—"
    return html.escape(str(v))


def render_status_page(title: str, sections: dict[str, Any]) -> bytes:
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title><style>{_STYLE}</style></head>",
        f"<body><h1>{html.escape(title)}</h1>",
    ]
    for name, value in sections.items():
        parts.append(f"<h2>{html.escape(name)}</h2>")
        parts.append(_render_value(value))
    parts.append("</body></html>")
    return "".join(parts).encode()
