"""The port's offline volume tools — ``fix``, ``export``, ``dump.dat``,
``dump.idx``, ``change.superblock``, ``compact`` and ``diff.servers`` —
against the JAX package's.

- The 11 cases of the reference's ``tests/test_offline_tools.py``, replayed
  with ``python -m seaweedfs_tpu_torch`` for the CLI and the port's
  ``Volume``/``Needle`` for the volumes they make (``diff.servers`` over a
  port master and two port volume servers).
- One volume's files fed to both packages' CLIs: the ``.idx`` that ``fix``
  rebuilds, the tar ``export`` writes (member names and bytes), the lines
  of ``dump.dat`` and ``dump.idx`` (``.idx`` and ``.ecx``) and the ``.dat``
  after ``change.superblock`` are byte-equal.
- ``diff.servers`` over a JAX and a port volume server holding the same
  volume: both packages' tools print the same lines and exit 1.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess
import sys
import tarfile
import threading

import numpy as np
import pytest

import seaweedfs_tpu.server.master_server as j_master_mod
import seaweedfs_tpu.server.volume_server as j_volume_mod
from seaweedfs_tpu.ec import encoder as jencoder
from seaweedfs_tpu_torch.server.http_util import http_bytes
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu_torch.storage.volume import Volume

import gateway_pair
from gateway_pair import _jax_classes, free_port

REPO = gateway_pair.REPO
REF = gateway_pair.ref_module("test_offline_tools")
PACKAGES = {"jax": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


def _cli(package: str, *args, cwd):
    return subprocess.run([sys.executable, "-m", package, *args],
                          env=dict(os.environ, PYTHONPATH=REPO), cwd=str(cwd),
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("case", gateway_pair.cases(REF))
def test_reference_case(case, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF, "_run", functools.partial(_cli, PACKAGES["port"]))
        mp.setattr(REF, "Volume", Volume)
        mp.setattr(REF, "Needle", Needle)
        mp.setattr(REF, "FLAG_HAS_NAME", FLAG_HAS_NAME)
        # diff.servers' case imports the servers in its body
        mp.setattr(j_master_mod, "MasterServer", MasterServer)
        mp.setattr(j_volume_mod, "VolumeServer",
                   functools.partial(VolumeServer, ec_backend="cpu"))
        getattr(REF, case)(tmp_path)


def _volume(tmp_path, vid=5) -> str:
    """A volume of named, unnamed, gzip'd, overwritten and deleted needles,
    with fixed times; returns its directory."""
    d = tmp_path / "src"
    d.mkdir()
    rng = np.random.default_rng(15)
    v = Volume(str(d), collection="", vid=vid)
    t0 = 1_700_000_000_000_000_000
    for i in range(1, 61):
        data = rng.bytes(int(rng.integers(1, 9000)))
        n = Needle(cookie=0x1000 + i, id=i, data=data)
        if i % 3:
            n.name = f"f{i:03d}.bin".encode()
            n.set_flag(FLAG_HAS_NAME)
        if i % 7 == 0:
            from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_LAST_MODIFIED

            n.last_modified = 1_700_000_000 + i
            n.set_flag(FLAG_HAS_LAST_MODIFIED)
        v.write_needle(n, append_at_ns=t0 + i)
    for i in range(5, 61, 9):  # deletes
        v.delete_needle(Needle(cookie=0x1000 + i, id=i), append_at_ns=t0 + 1000 + i)
    for i in (2, 4):  # overwrites
        v.write_needle(Needle(cookie=0x1000 + i, id=i, data=b"second version %d" % i),
                       append_at_ns=t0 + 2000 + i)
    v.close()
    return str(d)


def _fed(tmp_path, src) -> dict:
    """A copy of the volume's files for each package."""
    out = {}
    for kind in PACKAGES:
        out[kind] = tmp_path / kind
        shutil.copytree(src, out[kind])
    return out


def test_fix_rebuilds_the_same_idx(tmp_path):
    src = _volume(tmp_path)
    dirs = _fed(tmp_path, src)
    for kind, d in dirs.items():
        os.unlink(d / "5.idx")
        r = _cli(PACKAGES[kind], "fix", "-dir", ".", "-volumeId", "5", cwd=d)
        assert r.returncode == 0, r.stderr
    original = (tmp_path / "src" / "5.idx").read_bytes()
    assert (dirs["port"] / "5.idx").read_bytes() == (dirs["jax"] / "5.idx").read_bytes() \
        == original


def test_export_writes_the_same_members(tmp_path):
    src = _volume(tmp_path)
    dirs = _fed(tmp_path, src)
    members, outs = {}, {}
    for kind, d in dirs.items():
        r = _cli(PACKAGES[kind], "export", "-dir", ".", "-volumeId", "5", "-o", "out.tar",
                 cwd=d)
        assert r.returncode == 0, r.stderr
        outs[kind] = r.stdout
        with tarfile.open(d / "out.tar") as tf:
            members[kind] = [(m.name, m.size, tf.extractfile(m).read()) for m in tf.getmembers()]
    assert members["port"] == members["jax"] and outs["port"] == outs["jax"]
    names = [m[0] for m in members["port"]]
    assert "f001.bin" in names and "5_3" in names and "f005.bin" not in names
    # the overwrite carries no name: the tar names it by volume and key
    assert dict((m[0], m[2]) for m in members["port"])["5_2"] == b"second version 2"


@pytest.mark.parametrize("tool", ["dump.dat", "dump.idx", "dump.idx.ecx"])
def test_dumps_print_the_same_lines(tool, tmp_path):
    src = _volume(tmp_path)
    args = ["-dir", ".", "-volumeId", "5"]
    if tool == "dump.idx.ecx":
        jencoder.write_sorted_file_from_idx(os.path.join(src, "5"))
        tool, args = "dump.idx", args + ["-ext", ".ecx"]
    dirs = _fed(tmp_path, src)
    outs = {}
    for kind, d in dirs.items():
        r = _cli(PACKAGES[kind], tool, *args, cwd=d)
        assert r.returncode == 0, r.stderr
        outs[kind] = r.stdout
    assert outs["port"] == outs["jax"]
    assert outs["port"].count("\n") > 50


def test_change_superblock_writes_the_same_dat(tmp_path):
    src = _volume(tmp_path)
    dirs = _fed(tmp_path, src)
    outs = {}
    for kind, d in dirs.items():
        r = _cli(PACKAGES[kind], "change.superblock", "-dir", ".", "-volumeId", "5",
                 "-replication", "001", "-ttl", "3d", cwd=d)
        assert r.returncode == 0, r.stderr
        r2 = _cli(PACKAGES[kind], "change.superblock", "-dir", ".", "-volumeId", "5", cwd=d)
        outs[kind] = r.stdout + r2.stdout
    assert outs["port"] == outs["jax"]
    assert "Current Volume Replication: 001" in outs["port"]
    before = (tmp_path / "src" / "5.dat").read_bytes()
    after = (dirs["port"] / "5.dat").read_bytes()
    assert after == (dirs["jax"] / "5.dat").read_bytes()
    assert after[8:] == before[8:] and after[:8] != before[:8]


def test_diff_servers_across_packages(tmp_path):
    """One volume on a JAX and a port volume server, diverged: both
    packages' ``diff.servers`` print the same lines and exit 1."""
    jm_cls, jv_cls, _ = _jax_classes()
    jm = jm_cls(port=free_port(), node_timeout=60).start()
    pm = MasterServer(port=free_port(), node_timeout=60).start()
    jv = jv_cls([str(tmp_path / "j")], port=free_port(), master_url=jm.url,
                pulse_seconds=0.5, ec_backend="numpy").start()
    pv = VolumeServer([str(tmp_path / "p")], port=free_port(), master_url=pm.url,
                      pulse_seconds=0.5, ec_backend="cpu").start()
    servers = {"jax": f"127.0.0.1:{jv.port}", "port": f"127.0.0.1:{pv.port}"}
    try:
        vid = 9
        for url in servers.values():
            assert http_bytes("POST", f"http://{url}/admin/assign_volume?volume={vid}"
                                      "&replication=000")[0] == 200
            for i in range(1, 9):
                assert http_bytes("POST", f"http://{url}/{vid},{i:x}0000beef?type=replicate",
                                  b"same" * i)[0] == 201
        j, p = servers["jax"], servers["port"]
        assert http_bytes("POST", f"http://{j}/{vid},a0000beef?type=replicate", b"only")[0] == 201
        assert http_bytes("DELETE", f"http://{p}/{vid},30000beef?type=replicate")[0] in (200, 202)
        assert http_bytes("POST", f"http://{p}/{vid},40000beef?type=replicate",
                          b"a very different, longer body")[0] == 201
        jv.store.find_volume(vid).sync()
        pv.store.find_volume(vid).sync()
        both = f"{j},{p}"
        outs = {}
        for kind, package in PACKAGES.items():
            r = _cli(package, "diff.servers", "-volumeServers", both, "-volumeId", str(vid),
                     cwd=tmp_path)
            assert r.returncode == 1, r.stdout + r.stderr
            outs[kind] = r.stdout
        assert outs["port"] == outs["jax"]
        lines = outs["port"].splitlines()
        assert f"{vid},a {p} missing" in lines
        assert f"{vid},3 {p} deleted" in lines
        assert any(line.startswith(f"{vid},4 ") and line.endswith("wrongSize") for line in lines)
        assert lines[-1].startswith("# ") and "across 2 servers" in lines[-1]
        same = _cli(PACKAGES["port"], "diff.servers", "-volumeServers", f"{p},{p}",
                    "-volumeId", str(vid), cwd=tmp_path)
        assert same.returncode == 0 and same.stdout == "# 0 differences across 2 servers\n"
    finally:
        pv.stop()
        pm.stop()
        # the JAX servers' stop waits out their loops: let it run beside the rest
        threading.Thread(target=lambda: (jv.stop(), jm.stop()), daemon=True).start()


def test_dump_dat_of_a_torn_tail(tmp_path):
    """A record cut short at the end of the .dat is named, not fatal, by
    both packages."""
    src = _volume(tmp_path)
    with open(os.path.join(src, "5.dat"), "r+b") as f:
        f.truncate(os.path.getsize(os.path.join(src, "5.dat")) - 5)
    dirs = _fed(tmp_path, src)
    outs = {kind: _cli(PACKAGES[kind], "dump.dat", "-dir", ".", "-volumeId", "5", cwd=d)
            for kind, d in dirs.items()}
    assert outs["port"].stdout == outs["jax"].stdout
    assert "# torn record at offset" in outs["port"].stdout
    assert outs["port"].returncode == outs["jax"].returncode == 0

