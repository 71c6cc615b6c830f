"""The port's mount layer (``seaweedfs_tpu_torch/mount/``) against the JAX
package's.

- Every case of the reference's ``tests/test_mount.py``, replayed on the
  port (``gateway_pair.replay``): the port's ``WFS``, ``MetaCache``,
  ``MountSync`` and ``filer.copy`` over a port master, volume server and
  filer.
- ``ContinuousIntervals``: one seeded sequence of 2 000 ``add_interval`` /
  ``read_data_at`` / ``pop_largest_if_over`` calls on both packages' gives
  equal results at every step.
- One seeded script of writes, truncates, renames, appends and xattrs,
  through the JAX ``WFS`` over a JAX stack and through the port's over a
  port stack, ends in equal bytes and equal listings (name, size, mode,
  xattrs; fids differ).
- Each package's ``WFS`` reads the tree the other's wrote, over either
  package's filer, byte for byte: the port's at once, the JAX package's
  once its meta cache has applied the writer's last event.
- ``MountSync``'s state file and ``copy_from_filer``'s tree are the JAX
  package's: a state file written by one package's sync is resumed by the
  other's.

The tolerance is exact bytes throughout.
"""

from __future__ import annotations

import json
import os
import random
import time

import pytest

from seaweedfs_tpu.mount import WFS as JWFS
from seaweedfs_tpu.mount import ContinuousIntervals as JIntervals
from seaweedfs_tpu.mount.sync import MountSync as JMountSync
from seaweedfs_tpu_torch.filer.client import FilerClient as PFilerClient
from seaweedfs_tpu_torch.mount import WFS as PWFS
from seaweedfs_tpu_torch.mount import ContinuousIntervals as PIntervals
from seaweedfs_tpu_torch.mount.meta_cache import read_feed
from seaweedfs_tpu_torch.mount.sync import MountSync as PMountSync

import gateway_pair
from gateway_pair import Stack

REF = gateway_pair.ref_module("test_mount")
WFS_OF = {"jax": JWFS, "port": PWFS}


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mount")
    out = {"port": Stack("port", tmp), "jax": Stack("jax", tmp)}
    yield out
    for s in out.values():
        s.stop()


@pytest.mark.parametrize("case", gateway_pair.cases(REF))
def test_reference_case(case, stacks, tmp_path):
    gateway_pair.replay(REF, case, stack=stacks["port"], tmp_path=tmp_path)


def test_intervals_equal_on_a_seeded_sequence():
    rng = random.Random(2000)
    j, p = JIntervals(), PIntervals()
    for step in range(2000):
        op = rng.random()
        if op < 0.6:
            off, n = rng.randrange(0, 1 << 16), rng.randrange(1, 4096)
            data, ts = rng.randbytes(n), rng.randrange(1 << 40)
            j.add_interval(off, data, ts)
            p.add_interval(off, data, ts)
        elif op < 0.85:
            off, n = rng.randrange(0, 1 << 16), rng.randrange(0, 8192)
            assert j.read_data_at(off, n) == p.read_data_at(off, n), step
        else:
            limit = rng.randrange(1, 8192)
            a, b = j.pop_largest_if_over(limit), p.pop_largest_if_over(limit)
            assert (a is None) == (b is None), step
            if a is not None:
                assert (a.start, a.data, a.ts_ns) == (b.start, b.data, b.ts_ns), step
        assert [(i.start, i.data, i.ts_ns) for i in j.intervals] == \
            [(i.start, i.data, i.ts_ns) for i in p.intervals], step
        assert (j.total_size(), j.max_stop()) == (p.total_size(), p.max_stop()), step


def _script(wfs, root: str, seed: int) -> None:
    """Seeded writes, truncates, renames, appends and xattrs under ``root``."""
    rng = random.Random(seed)
    wfs.mkdir(root)
    wfs.mkdir(f"{root}/sub")
    names = []
    for i in range(6):
        path = f"{root}/{'sub/' if i % 2 else ''}f{i}.bin"
        with wfs.open(path, "w") as f:
            for _ in range(rng.randrange(1, 12)):
                f.write(rng.randrange(0, 300_000), rng.randbytes(rng.randrange(1, 70_000)))
        names.append(path)
    wfs.write_file(f"{root}/small.txt", b"small file")
    names.append(f"{root}/small.txt")
    with wfs.open(names[0], "a") as f:  # append ignores the offset
        f.write(0, rng.randbytes(5000))
    with wfs.open(names[1], "r+") as f:  # mid-file truncation, then a write past it
        f.truncate(f.size() // 3)
        f.write(f.size() + 100, rng.randbytes(777))
    with wfs.open(names[2], "r+") as f:
        f.truncate(0)
        f.write(0, b"rewritten")
    wfs.rename(names[3], f"{root}/renamed.bin")
    wfs.setxattr(names[0], "user.color", b"indigo")
    wfs.setxattr(names[0], "user.bin", bytes(range(256)))
    wfs.setxattr(f"{root}/renamed.bin", "user.gone", b"x")
    wfs.removexattr(f"{root}/renamed.bin", "user.gone")
    wfs.setxattr(f"{root}/renamed.bin", "user.kept", b"y")
    with wfs.open(names[4], "r+") as f:  # an xattr set while a handle is open
        wfs.setxattr(names[4], "user.live", b"while-open")
        f.write(10, rng.randbytes(1000))
    wfs.unlink(names[5])


def _tree(wfs, root: str) -> list:
    """(path, is_dir, size, mode, xattrs, bytes) of every entry under root."""
    out, stack = [], [root]
    while stack:
        d = stack.pop()
        for e in wfs.listdir(d):
            if e.is_directory:
                stack.append(e.full_path)
                out.append((e.full_path, True, 0, e.mode, {}, b""))
                continue
            xattrs = {n: wfs.getxattr(e.full_path, n) for n in wfs.listxattr(e.full_path)}
            out.append((e.full_path, False, e.file_size(), e.mode, xattrs,
                        wfs.read_file(e.full_path)))
    return sorted(out)


def test_wfs_script_equal_across_packages(stacks):
    trees = {}
    for kind in ("jax", "port"):
        wfs = WFS_OF[kind](stacks[kind].url, chunk_size=64 * 1024, use_meta_cache=False)
        try:
            _script(wfs, "/script", 1414)
            trees[kind] = _tree(wfs, "/script")
        finally:
            wfs.close()
    assert len(trees["port"]) == 7  # six files and a directory
    assert trees["port"] == trees["jax"]


@pytest.mark.parametrize("filer_kind", ["jax", "port"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wfs_reads_the_other_packages_tree(stacks, filer_kind, writer):
    reader = "port" if writer == "jax" else "jax"
    root = f"/cross-{writer}-on-{filer_kind}"
    url = stacks[filer_kind].url
    w = WFS_OF[writer](url, chunk_size=64 * 1024, use_meta_cache=False)
    r = WFS_OF[reader](url, chunk_size=64 * 1024)  # the reader's meta cache on
    try:
        _script(w, root, 7)
        if reader == "jax":
            _until_applied(r.meta_cache, url)
        assert _tree(r, root) == _tree(w, root)
    finally:
        w.close()
        r.close()


def _until_applied(cache, url: str, timeout: float = 10.0) -> None:
    """Wait until ``cache`` has applied the filer's last event. The JAX
    package's cache replays an event older than a listing over it (an entry
    the writer renamed away comes back until a later poll), where the port's
    drops it: so a JAX reader walks the tree only once its poller is past
    the writer's last event, and a port reader at once."""
    head = read_feed(PFilerClient(url), cache._last_ts_ns)[1]
    deadline = time.time() + timeout
    while cache._last_ts_ns < head and time.time() < deadline:
        time.sleep(0.05)
    assert cache._last_ts_ns >= head, "the JAX reader's cache never caught up"


@pytest.mark.parametrize("first", ["jax", "port"])
def test_mount_sync_state_carries_across_packages(stacks, tmp_path, first):
    """One package's ``MountSync`` materializes and records a tree; the
    other's resumes from that state file and pushes only the new file."""
    second = "port" if first == "jax" else "jax"
    sync_of = {"jax": JMountSync, "port": PMountSync}
    url, remote = stacks["port"].url, f"/msync-{first}"
    w = PWFS(url, use_meta_cache=False)
    w.mkdir(remote)
    w.write_file(f"{remote}/a.txt", b"remote a")
    local = tmp_path / "mnt"
    ms = sync_of[first](url, remote, str(local), scan_seconds=3600).start()
    ms.stop()
    state = json.loads((local / ".weed_mount_state.json").read_text())
    assert set(state["state"]) == {"a.txt"}
    (local / "b.txt").write_bytes(b"local b")
    ms = sync_of[second](url, remote, str(local), scan_seconds=3600).start()
    try:
        assert ms.sync_once()["pushed"] == 1  # b.txt only: a.txt is known
        assert w.read_file(f"{remote}/b.txt") == b"local b"
        w.write_file(f"{remote}/c.txt", b"remote c")
        deadline = time.time() + 10
        while time.time() < deadline and not (local / "c.txt").exists():
            ms.sync_once()
        assert (local / "c.txt").read_bytes() == b"remote c"
    finally:
        ms.stop()
        w.close()
    assert sorted(os.listdir(local)) == [".weed_mount_state.json", "a.txt", "b.txt", "c.txt"]
