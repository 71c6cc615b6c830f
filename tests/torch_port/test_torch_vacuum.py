"""The port's vacuum (``Volume.compact``) against the JAX package's, byte for
byte.

The same seeded needles, with fixed append times, go into a volume of each
package; the same keys are deleted and both compact. The compacted .dat and
.idx must be identical, and so must ``garbage_level`` and every read. Writes,
overwrites and deletes injected at the ``vacuum.copy`` fault point (while
the unlocked copy runs) must land in both alike, tombstones included. The
compaction revision wraps at 0xFFFF and the super block's extra bytes are
carried over; a second compaction while one runs is refused; a crash at each
step of the vacuum commit leaves a volume that loads with every live needle
and no deleted one, as the reference's crash matrix checks. Exact equality
everywhere: there is no tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle as jneedle
from seaweedfs_tpu.storage import volume as jvolume
from seaweedfs_tpu.util import faultpoints as jfaultpoints
from seaweedfs_tpu_torch.storage import needle as pneedle
from seaweedfs_tpu_torch.storage import volume as pvolume
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation as PDiskLocation
from seaweedfs_tpu_torch.util import faultpoints as pfaultpoints

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VID = 9
T0 = 1_700_000_000_000_000_000
N = 120

PACKAGES = {
    "jax": (jvolume, jneedle, jfaultpoints),
    "port": (pvolume, pneedle, pfaultpoints),
}


def _blobs(seed=5):
    rng = np.random.default_rng(seed)
    return {i: rng.bytes(int(np.exp(rng.uniform(np.log(1), np.log(30_000)))))
            for i in range(1, N + 1)}


def _deleted(seed=5):
    rng = np.random.default_rng(seed + 1)
    return sorted(int(i) for i in rng.choice(np.arange(1, N + 1), N * 3 // 10, replace=False))


def _build(pkg, d, kind, extra=b"", revision=0):
    """A volume of N needles (some overwritten), ~30 % deleted."""
    vmod, nmod, _ = PACKAGES[pkg]
    os.makedirs(d, exist_ok=True)
    v = vmod.Volume(d, "", VID, needle_map_kind=kind)
    if extra or revision:
        v.super_block.extra = extra
        v.super_block.compaction_revision = revision
        v.data_backend.write_at(0, v.super_block.to_bytes())
    t = T0
    blobs = _blobs()
    for i, data in blobs.items():
        t += 1
        v.write_needle(nmod.Needle(cookie=0x700 + i, id=i, data=data), append_at_ns=t)
    for i in range(5, N, 17):  # overwrites: the old copy is garbage
        t += 1
        v.write_needle(nmod.Needle(cookie=0x700 + i, id=i, data=b"new %d" % i), append_at_ns=t)
        blobs[i] = b"new %d" % i
    for i in _deleted():
        t += 1
        v.delete_needle(nmod.Needle(cookie=0x700 + i, id=i), append_at_ns=t)
    v.sync()
    return v, blobs, t


def _files(d):
    out = {}
    for ext in (".dat", ".idx"):
        with open(os.path.join(d, f"{VID}{ext}"), "rb") as f:
            out[ext] = f.read()
    return out


def _reads(pkg, v, keys):
    _, nmod, _ = PACKAGES[pkg]
    out = []
    for k in keys:
        n = nmod.Needle(id=k)
        try:
            out.append((v.read_needle(n), n.cookie, n.data, n.append_at_ns))
        except Exception as e:  # noqa: BLE001 — the error's kind is compared
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("kind", ["dense", "memory"])
def test_compact_gives_identical_files(tmp_path, kind):
    res = {}
    for pkg in PACKAGES:
        d = str(tmp_path / pkg)
        v, blobs, _ = _build(pkg, d, kind)
        before = (v.garbage_level(), v.size(), _files(d))
        v.compact()
        after = (v.garbage_level(), v.size(), v.super_block.compaction_revision,
                 v.file_count(), v.deleted_count(), v.content_size(), v.deleted_size())
        reads = _reads(pkg, v, range(0, N + 3))
        v.close()
        # reopened from disk, the compacted volume reads the same
        v2 = PACKAGES[pkg][0].Volume(d, "", VID, create_if_missing=False, needle_map_kind=kind)
        reopened = _reads(pkg, v2, range(0, N + 3))
        v2.close()
        res[pkg] = (before, after, reads, reopened, _files(d))
    assert res["port"] == res["jax"]
    before, after, reads, reopened, files = res["port"]
    assert before[0] > 0.1
    assert after[0] == 0.0 and after[2] == 1
    assert len(files[".dat"]) < len(before[2][".dat"])
    assert reads == reopened
    dead = set(_deleted())
    live = [r for k, r in zip(range(0, N + 3), reads) if 1 <= k <= N and k not in dead]
    assert all(isinstance(r, tuple) for r in live)
    assert all(reads[k] == "NotFoundError" for k in dead)


def _inject(pkg, v, t0, hit_at, log):
    """A fault-point hook: on the ``hit_at``-th live-needle copy, write new
    needles, overwrite and delete live ones (some copied already, some not),
    delete a just-written one, and try a second compaction."""
    _, nmod, fp = PACKAGES[pkg]
    real = fp.fire
    hits = [0]

    def fire(name, path=None):
        if name == "vacuum.copy":
            hits[0] += 1
            if hits[0] == hit_at:
                t = t0
                for i in range(1000, 1012):
                    t += 1
                    v.write_needle(nmod.Needle(cookie=0x99, id=i, data=b"mid %d" % i * 40),
                                   append_at_ns=t)
                for i in (2, 3, N - 1):  # overwrites of live needles
                    t += 1
                    v.write_needle(nmod.Needle(cookie=0x700 + i, id=i, data=b"over %d" % i),
                                   append_at_ns=t)
                for i in (1, 4, N - 2, 1003):  # deletes: copied, not yet, new
                    t += 1
                    log.append((i, v.delete_needle(nmod.Needle(cookie=0, id=i),
                                                   append_at_ns=t)))
                try:
                    v.compact()
                    log.append("second compaction ran")
                except Exception as e:  # noqa: BLE001 — the error's kind is compared
                    log.append(type(e).__name__)
        return real(name, path)

    return fire


@pytest.mark.parametrize("kind", ["dense", "memory"])
@pytest.mark.parametrize("hit_at", [1, 37])
def test_writes_and_deletes_during_the_copy_survive(tmp_path, monkeypatch, kind, hit_at):
    res = {}
    for pkg in PACKAGES:
        d = str(tmp_path / pkg)
        v, _, t = _build(pkg, d, kind)
        log: list = []
        monkeypatch.setattr(PACKAGES[pkg][2], "fire", _inject(pkg, v, t, hit_at, log))
        v.compact()
        monkeypatch.undo()
        reads = _reads(pkg, v, list(range(0, N + 3)) + list(range(1000, 1013)))
        counters = (v.file_count(), v.deleted_count(), v.garbage_level())
        v.close()
        v2 = PACKAGES[pkg][0].Volume(d, "", VID, create_if_missing=False, needle_map_kind=kind)
        reopened = _reads(pkg, v2, list(range(0, N + 3)) + list(range(1000, 1013)))
        v2.close()
        res[pkg] = (log, reads, reopened, counters, _files(d))
    assert res["port"] == res["jax"]
    log, reads, reopened, _, _ = res["port"]
    assert "VolumeError" in log  # the second compaction was refused
    assert reads == reopened  # the replayed tombstones survive the reload
    by_key = dict(zip(list(range(0, N + 3)) + list(range(1000, 1013)), reads))
    for i in (1, 4, N - 2, 1003):
        assert by_key[i] in ("NotFoundError", "DeletedError"), i
    assert by_key[2][2] == b"over 2" and by_key[1000][2] == b"mid 1000" * 40


def test_compaction_revision_wraps_and_keeps_extra(tmp_path):
    res = {}
    for pkg in PACKAGES:
        d = str(tmp_path / pkg)
        v, _, _ = _build(pkg, d, "dense", extra=b"\x0a\x06abcdef", revision=0xFFFF)
        v.compact()
        sb = v.super_block
        reads = _reads(pkg, v, range(1, N + 1))
        v.close()
        res[pkg] = (sb.compaction_revision, sb.extra, reads, _files(d))
    assert res["port"] == res["jax"]
    assert res["port"][0] == 0 and res["port"][1] == b"\x0a\x06abcdef"


def test_destroy_refused_while_compacting(tmp_path, monkeypatch):
    res = {}
    for pkg in PACKAGES:
        v, _, _ = _build(pkg, str(tmp_path / pkg), "dense")
        _, _, fp = PACKAGES[pkg]
        real, seen = fp.fire, []

        def fire(name, path=None, v=v, seen=seen, real=real):
            if name == "vacuum.copy" and not seen:
                try:
                    v.destroy()
                    seen.append("destroyed")
                except Exception as e:  # noqa: BLE001 — the error's kind is compared
                    seen.append(type(e).__name__)
            return real(name, path)

        monkeypatch.setattr(fp, "fire", fire)
        v.compact()
        monkeypatch.undo()
        v.close()
        res[pkg] = seen
    assert res["port"] == res["jax"] == ["VolumeError"]


CHILD = r"""
import sys
sys.path.insert(0, sys.argv[2])
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

v = Volume(sys.argv[1], "", 1)
for i in range(1, 41):
    v.write_needle(Needle(cookie=7, id=i, data=bytes([i % 251]) * (1000 + i * 37)))
for i in range(1, 41, 3):
    v.delete_needle(Needle(cookie=7, id=i))
v.compact()
v.close()
print("CHILD-COMPLETED")
"""


@pytest.mark.parametrize("faultspec", [
    None,
    "vacuum.copy=crash::13",
    "vacuum.staged=crash",
    "vacuum.staged=torn-write:0.5",
    "vacuum.manifest=crash",
    "vacuum.rename=crash",
    "vacuum.renamed=crash",
])
def test_crash_during_vacuum_leaves_a_loadable_volume(tmp_path, faultspec):
    """The reference's crash matrix on the port: a child compacts with a
    fault point armed and dies there; the startup scan of a DiskLocation
    then rolls the commit forward or back, and every live needle reads its
    bytes and every deleted one stays deleted, in either package."""
    env = dict(os.environ)
    env.pop("SWEED_FAULTPOINTS", None)
    if faultspec:
        env["SWEED_FAULTPOINTS"] = faultspec
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path), REPO],
                          env=env, capture_output=True, text=True, timeout=120)
    if faultspec:
        assert proc.returncode == pfaultpoints.CRASH_EXIT_CODE, proc.stderr
    else:
        assert proc.returncode == 0 and "CHILD-COMPLETED" in proc.stdout, proc.stderr
    loc = PDiskLocation(str(tmp_path))
    loc.load_existing_volumes()
    try:
        litter = [f for f in os.listdir(tmp_path)
                  if f.endswith((".cpd", ".cpx", ".commit", ".tmp"))]
        assert not litter, litter
        v = loc.find_volume(1)
        assert v is not None
        reads = _reads("port", v, range(1, 41))
    finally:
        loc.close()
    jv = jvolume.Volume(str(tmp_path), "", 1, create_if_missing=False)
    try:
        assert _reads("jax", jv, range(1, 41)) == reads
    finally:
        jv.close()
    for i, r in zip(range(1, 41), reads):
        if i % 3 == 1:
            assert r in ("NotFoundError", "DeletedError"), i
        else:
            assert r[2] == bytes([i % 251]) * (1000 + i * 37), i
