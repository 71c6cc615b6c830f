"""Image resize on read and EXIF re-orientation (`weed/images/resizing.go`,
`orientation.go`), as the JAX package's ``util/images.py`` does them.

A volume server's ``GET /<fid>?width=&height=&mode=fit|fill`` returns an
image needle resized; ``fix_orientation`` bakes a JPEG's EXIF orientation
into its pixels. Both need PIL: without it they return the bytes they were
given, in both packages alike.
"""

from __future__ import annotations

import io
from typing import Optional

try:
    from PIL import Image

    HAVE_PIL = True
except ImportError:  # pragma: no cover — a host without PIL serves originals
    HAVE_PIL = False

_EXIF_ORIENTATION = 274
_TRANSPOSE = {
    2: "FLIP_LEFT_RIGHT",
    3: "ROTATE_180",
    4: "FLIP_TOP_BOTTOM",
    5: "TRANSPOSE",
    6: "ROTATE_270",
    7: "TRANSVERSE",
    8: "ROTATE_90",
}


def is_image(mime: str) -> bool:
    return mime.startswith("image/")


def fix_orientation(data: bytes, mime: str = "image/jpeg") -> bytes:
    """Bake the EXIF orientation into the pixels (orientation.go)."""
    if not HAVE_PIL or "jpeg" not in mime:
        return data
    try:
        img = Image.open(io.BytesIO(data))
        exif = img.getexif()
        op = _TRANSPOSE.get(exif.get(_EXIF_ORIENTATION, 1))
        if op is None:
            return data
        img = img.transpose(getattr(Image.Transpose, op))
        exif[_EXIF_ORIENTATION] = 1
        out = io.BytesIO()
        img.save(out, format="JPEG", exif=exif.tobytes(), quality=95)
        return out.getvalue()
    except Exception:  # noqa: BLE001 — a bad image is served as stored
        return data


def resized(data: bytes, mime: str, width: Optional[int] = None,
            height: Optional[int] = None, mode: str = "") -> bytes:
    """``fit`` (the default: keep the ratio, bounded by width and height) or
    ``fill`` (crop to exactly width x height), as resizing.go's Resized."""
    if not HAVE_PIL or not is_image(mime) or not (width or height):
        return data
    try:
        img = Image.open(io.BytesIO(data))
        fmt = (img.format or "").upper()  # lost by resize and crop
        ow, oh = img.size
        w, h = width or ow, height or oh
        if mode == "fill":
            scale = max(w / ow, h / oh)
            img = img.resize((max(1, round(ow * scale)), max(1, round(oh * scale))))
            left = (img.width - w) // 2
            top = (img.height - h) // 2
            img = img.crop((left, top, left + w, top + h))
        else:  # fit
            img.thumbnail((w, h))
        out = io.BytesIO()
        fmt = fmt or {"image/png": "PNG", "image/gif": "GIF"}.get(mime, "JPEG")
        if fmt == "JPEG" and img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        img.save(out, format=fmt)
        return out.getvalue()
    except Exception:  # noqa: BLE001 — a bad image is served as stored
        return data
