"""Image resize on read and EXIF re-orientation: the port's
``util/images.py`` and its volume server against the JAX package's.

- The reference's ``tests/test_aux.py`` image cases replayed on the port:
  ``test_image_resize_fit_and_fill`` and ``test_exif_orientation`` with the
  port's ``resized`` and ``fix_orientation``, ``test_volume_image_resize``
  against a port master, volume server and filer.
- One PNG and one EXIF-rotated JPEG through both packages' functions give
  equal bytes.
- ``GET /<fid>?width=...`` against each package's volume server gives equal
  bytes and status: a resize, a fill crop, a resize that ignores ``Range``,
  an ignored ``?width=zz`` that keeps it, and a resize with the needle
  cache on (a cached original must not answer a resize, nor a resize fill
  the cache).
"""

from __future__ import annotations

import io
import urllib.request

import pytest

from seaweedfs_tpu.util import images as jimages
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.util import images as pimages

import gateway_pair
from gateway_pair import Stack

pytestmark = pytest.mark.skipif(not (jimages.HAVE_PIL and pimages.HAVE_PIL),
                                reason="PIL not available (the reference's own gate)")

REF = gateway_pair.ref_module("test_aux")
KINDS = ("jax", "port")


def _png(size=(80, 40), color="green") -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return buf.getvalue()


def _rotated_jpeg() -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    img = Image.new("RGB", (60, 30), "blue")
    for x in range(0, 60, 7):  # some structure, so a transpose shows
        img.putpixel((x, x % 30), (255, 255, 0))
    exif = img.getexif()
    exif[274] = 6
    img.save(buf, format="JPEG", exif=exif.tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    out = {k: Stack(k, tmp_path_factory.mktemp(f"img-{k}")) for k in KINDS}
    yield out
    for s in out.values():
        s.stop()


@pytest.mark.parametrize("case", ["test_image_resize_fit_and_fill", "test_exif_orientation"])
def test_reference_case(case):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF, "resized", pimages.resized)
        mp.setattr(REF, "fix_orientation", pimages.fix_orientation)
        getattr(REF, case)()


def test_reference_volume_image_resize(stacks):
    s = stacks["port"]
    REF.test_volume_image_resize((s.master, s.volume, s.filer))


@pytest.mark.parametrize("mode,size", [("", (50, 50)), ("fill", (40, 40)), ("", (40, None)),
                                       ("", (None, 10))])
def test_resized_bytes_equal(mode, size):
    png = _png((100, 60), "red")
    w, h = size
    assert pimages.resized(png, "image/png", w, h, mode) == \
        jimages.resized(png, "image/png", w, h, mode)
    jpeg = _rotated_jpeg()
    assert pimages.resized(jpeg, "image/jpeg", w, h, mode) == \
        jimages.resized(jpeg, "image/jpeg", w, h, mode)


def test_fix_orientation_bytes_equal():
    jpeg = _rotated_jpeg()
    fixed = pimages.fix_orientation(jpeg)
    assert fixed == jimages.fix_orientation(jpeg) and fixed != jpeg
    png = _png()
    assert pimages.fix_orientation(png, "image/png") == png
    assert pimages.fix_orientation(b"not a jpeg") == b"not a jpeg"


def _upload(stack, data: bytes, mime: str) -> str:
    a = http_json("GET", f"http://{stack.master.url}/dir/assign")
    status, _ = http_bytes("POST", f"http://{a['url']}/{a['fid']}", data,
                           headers={"X-Sweed-Mime": mime})
    assert status == 201, status
    return f"{a['url']}/{a['fid']}"


def _get(url: str, query: str, headers=None) -> tuple:
    req = urllib.request.Request(f"http://{url}{query}", headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read()


QUERIES = [
    ("?width=40", None),
    ("?width=40&height=40&mode=fill", None),
    ("?height=10", None),
    ("?width=40", {"Range": "bytes=0-3"}),  # a resize ignores Range
    ("?width=zz", {"Range": "bytes=0-3"}),  # an ignored width keeps it
    ("?width=-5", None),
    ("", None),
]


@pytest.mark.parametrize("query,headers", QUERIES)
def test_volume_get_resize_equal(stacks, query, headers):
    """The same image through each package's volume server: equal replies.
    On the parent tree the port served the original bytes for a resize."""
    from PIL import Image

    png = _png()
    got = {}
    for kind, s in stacks.items():
        url = _upload(s, png, "image/png")
        got[kind] = _get(url, query, headers)
    assert got["port"] == got["jax"]
    status, data = got["port"]
    if query.startswith("?width=4") or query.startswith("?height"):
        assert status == 200 and data != png
        assert Image.open(io.BytesIO(data)).size != (80, 40)
    elif headers:
        assert (status, data) == (206, png[:4])
    else:
        assert (status, data) == (200, png)


def test_resize_bypasses_the_needle_cache(stacks):
    """With the hot-needle cache on, a cached original does not answer a
    resize, and a resize does not fill the cache: both packages alike."""
    png = _png((64, 64), "purple")
    got = {}
    for kind, s in stacks.items():
        vurl = f"{s.volume.host}:{s.volume.port}"
        assert http_bytes("POST", f"http://{vurl}/admin/ncache?capacity={8 << 20}")[0] == 200
        try:
            url = _upload(s, png, "image/png")
            first = _get(url, "?width=16")  # a resize first: nothing cached
            plain = _get(url, "")  # populates the cache
            again = _get(url, "?width=16")  # must not be the cached original
            got[kind] = (first, plain, again)
        finally:
            http_bytes("POST", f"http://{vurl}/admin/ncache?capacity=0")
    assert got["port"] == got["jax"]
    first, plain, again = got["port"]
    assert plain == (200, png) and first == again and first[1] != png
