"""The port's kernel-visible FUSE mount (``mount/fuse_mount.py``): every case
of the reference's ``tests/test_fuse_mount.py``, replayed against the port's
``FuseMount`` over the port's ``WFS``, master, volume server and filer.

Gated as the reference is: skipped where libfuse 2.x, ``/dev/fuse`` or
x86_64 is missing, and a case skips where the environment refuses the
mount. Every mount is unmounted in the teardown. The libfuse ABI layouts
(``Stat``, ``FuseFileInfo``, ``FuseOperations``) are also checked equal to
the JAX package's field by field, which needs no mount.
"""

from __future__ import annotations

import ctypes
import inspect

import pytest

import seaweedfs_tpu.mount.fuse_mount as j_fuse
import seaweedfs_tpu_torch.mount.fuse_mount as p_fuse
from seaweedfs_tpu_torch.mount import WFS

import gateway_pair
from gateway_pair import Stack

REF = gateway_pair.ref_module("test_fuse_mount")


needs_fuse = pytest.mark.skipif(
    not gateway_pair.can_mount(), reason="libfuse / /dev/fuse / mount privileges missing")


@pytest.fixture()
def mounted(tmp_path):
    stack = Stack("port", tmp_path)
    wfs = WFS(stack.url)
    fm = None
    try:
        fm = p_fuse.FuseMount(wfs, str(tmp_path / "mnt")).mount()
    except Exception as e:  # the environment refuses mounts: skip, as the reference does
        wfs.close()
        stack.stop()
        pytest.skip(f"fuse mount refused here: {e}")
    yield str(tmp_path / "mnt")
    fm.unmount()
    wfs.close()
    stack.stop()


@needs_fuse
@pytest.mark.parametrize("case", gateway_pair.cases(REF))
def test_reference_case(case, tmp_path, request):
    fixtures = {"tmp_path": tmp_path}
    if "mounted" in inspect.signature(getattr(REF, case)).parameters:
        fixtures["mounted"] = request.getfixturevalue("mounted")
    gateway_pair.replay(REF, case, **fixtures)


@pytest.mark.parametrize("name", ["Timespec", "Stat", "FuseFileInfo", "FuseOperations"])
def test_abi_layouts_equal(name):
    j, p = getattr(j_fuse, name), getattr(p_fuse, name)
    assert ctypes.sizeof(j) == ctypes.sizeof(p)
    assert [(f[0], ctypes.sizeof(f[1])) for f in j._fields_] == \
        [(f[0], ctypes.sizeof(f[1])) for f in p._fields_]
    for field, _ in p._fields_:
        assert getattr(j, field).offset == getattr(p, field).offset, field


def test_fuse_available_agrees():
    assert p_fuse.fuse_available() == j_fuse.fuse_available()
