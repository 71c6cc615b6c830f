"""The volume server's maintenance routes on a port server against a JAX
server holding an equal volume.

Each of the two servers runs beside a port master of its own. The same
seeded needles, with fixed append times (a group of them sharing one time
stamp), go into volume ``VID`` on both through their stores. Then each of
the eight routes must answer alike: ``/admin/vacuum_check``,
``/admin/volume_status`` and ``/admin/vacuum`` with equal JSON (and equal
files after the vacuum), ``/admin/tail`` and ``/admin/incremental_copy`` with
equal bytes and headers page by page, ``/admin/volume_configure_replication``
with the same super block byte on disk, ``/admin/volume_copy`` pulling across
the two packages both ways, and ``/admin/server_leave`` taking the node out
of its master at once. ``backup`` crosses both ways: the port's
``backup_volume`` of the JAX server and the JAX package's of the port server
give equal local files, after a full pass and after an incremental one.

The repair: on a cluster made only of the port, ``/vol/vacuum`` used to get a
404 from ``/admin/vacuum_check``, read it as a clean volume and compact
nothing. It must now compact the volume above the threshold, keep every
live needle and drop the deleted ones, and the master must see the new
compaction revision. Exact equality everywhere; there is no tolerance.
"""

import contextlib
import os
import socket
import threading
import time

import numpy as np

from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.storage import volume_backup as jbackup
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_bytes_headers, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.storage import volume_backup as pbackup
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle

VID = 12
COLLECTION = "maint"
T0 = 1_700_000_000_000_000_000
KINDS = {"jax": (JVolumeServer, JNeedle, "numpy"), "port": (PVolumeServer, PNeedle, "cpu")}
X_HEADERS = ("X-Volume-Version", "X-Last-Append-Ns", "X-Dat-Size", "X-Compaction-Revision")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def _fill(srv, kind, vid, first, count, t0, seed):
    """``count`` seeded needles from key ``first``; keys 30-35 share one
    append time. Then every 4th of them is deleted."""
    ncls = KINDS[kind][1]
    v = srv.store.find_volume(vid)
    rng = np.random.default_rng(seed)
    for i in range(first, first + count):
        t = t0 + (30 if 30 <= i - first <= 35 else i - first)
        v.write_needle(ncls(cookie=0x300 + i, id=i,
                            data=rng.bytes(int(rng.integers(100, 40_000)))),
                       append_at_ns=t)
    for j, i in enumerate(range(first, first + count, 4)):
        v.delete_needle(ncls(cookie=0x300 + i, id=i), append_at_ns=t0 + 10_000 + j)
    v.sync()


@contextlib.contextmanager
def _twins(tmp_path, vids=(VID,)):
    """A JAX and a port volume server, each under a port master of its own,
    each holding equal volumes ``vids``. Yields {kind: (server, master)}."""
    out = {}
    try:
        for kind, (vcls, _, backend) in KINDS.items():
            master = PMasterServer(port=_free_port(), node_timeout=60).start()
            srv = vcls([str(tmp_path / kind)], port=_free_port(), master_url=master.url,
                       pulse_seconds=0.3, ec_backend=backend).start()
            out[kind] = (srv, master)
            for vid in vids:
                srv.store.add_volume(vid, collection=COLLECTION)
                _fill(srv, kind, vid, 1, 80, T0, seed=vid)
            assert _wait(lambda: all(vid in dn.volumes for vid in vids
                                     for dn in master.master.topo.data_nodes()))
        yield out
    finally:
        for srv, master in out.values():
            srv.stop()
            master.stop()


def _url(srv):
    return f"127.0.0.1:{srv.port}"


def _get(srv, path):
    status, body, headers = http_bytes_headers("GET", f"http://{_url(srv)}{path}")
    return status, body, {k: headers[k] for k in X_HEADERS if k in headers}


def _file(srv, vid, ext):
    status, data = http_bytes(
        "GET", f"http://{_url(srv)}/admin/file?volume={vid}&collection={COLLECTION}&ext={ext}")
    assert status == 200, (ext, status)
    return data


def _tail_pages(srv, since, max_bytes):
    pages = []
    while True:
        status, body, headers = _get(
            srv, f"/admin/tail?volume={VID}&since_ns={since}&max_bytes={max_bytes}")
        assert status == 200
        pages.append((body, headers))
        if not body:
            return pages
        since = int(headers["X-Last-Append-Ns"])


def test_read_routes_answer_alike(tmp_path):
    with _twins(tmp_path) as tw:
        res = {}
        for kind, (srv, _) in tw.items():
            r = {
                "vacuum_check": http_json(
                    "GET", f"http://{_url(srv)}/admin/vacuum_check?volume={VID}"),
                "vacuum_check_404": http_json(
                    "GET", f"http://{_url(srv)}/admin/vacuum_check?volume=99"),
                "status": http_json(
                    "GET", f"http://{_url(srv)}/admin/volume_status?volume={VID}"),
                "status_404": http_json(
                    "GET", f"http://{_url(srv)}/admin/volume_status?volume=99"),
                # pages of ~24 KB: a page never splits the group of keys 30-35
                "tail": _tail_pages(srv, 0, 24_000),
                # one record a page, but the six of one time stamp in one
                "tail_1": _tail_pages(srv, 0, 1),
                "tail_since": _tail_pages(srv, T0 + 33, 1 << 20),
                "copy": [_get(srv, f"/admin/incremental_copy?volume={VID}"
                                   f"&offset={off}&max_bytes={mb}")
                         for off, mb in ((0, 65536), (100_000, 1 << 20), (8, 10),
                                         (10**9, 4096))],
            }
            res[kind] = r
        assert res["port"] == res["jax"]
        r = res["port"]
        assert 0 < r["vacuum_check"]["garbage_ratio"] < 1
        assert r["status"]["compaction_revision"] == 0 and r["status"]["file_count"] == 80
        assert len(r["tail"]) > 3 and r["tail"][-1][0] == b""
        assert len(r["tail_1"]) == 100 - 5 + 1
        # the frames decode alike in both packages, every record once
        blob = b"".join(body for body, _ in r["tail"])
        pn = pbackup.parse_tail_frames(blob, 3)
        jn = jbackup.parse_tail_frames(blob, 3)
        assert [(n.id, n.cookie, n.size, n.data, n.append_at_ns) for n in pn] == \
            [(n.id, n.cookie, n.size, n.data, n.append_at_ns) for n in jn]
        assert len(pn) == 80 + 20
        assert r["copy"][0][1] == _file(tw["port"][0], VID, ".dat")[:65536]
        assert r["copy"][3][1] == b""


def test_vacuum_route_compacts_alike(tmp_path):
    with _twins(tmp_path) as tw:
        res = {}
        for kind, (srv, _) in tw.items():
            before = len(_file(srv, VID, ".dat"))
            reply = http_json("POST", f"http://{_url(srv)}/admin/vacuum?volume={VID}"
                                      f"&compactionBytePerSecond=0")
            res[kind] = (before, reply,
                         http_json("GET", f"http://{_url(srv)}/admin/volume_status?volume={VID}"),
                         http_json("GET", f"http://{_url(srv)}/admin/vacuum_check?volume={VID}"),
                         _file(srv, VID, ".dat"), _file(srv, VID, ".idx"),
                         http_json("POST", f"http://{_url(srv)}/admin/vacuum?volume=99"))
        assert res["port"] == res["jax"]
        before, reply, status, check, dat, _, missing = res["port"]
        assert reply == {"size": len(dat)} and len(dat) < before
        assert status["compaction_revision"] == 1 and check == {"garbage_ratio": 0.0}
        assert missing["_status"] == 404


def test_configure_replication_persists_alike(tmp_path):
    with _twins(tmp_path) as tw:
        res = {}
        for kind, (srv, master) in tw.items():
            reply = http_json("POST", f"http://{_url(srv)}/admin/volume_configure_replication"
                                      f"?volume={VID}&replication=001")
            dat = _file(srv, VID, ".dat")
            assert _wait(lambda: master.master.topo.data_nodes()[0].volumes[VID]
                         .replica_placement.to_byte() == 1)
            res[kind] = (reply, dat[:8], dat)
        assert res["port"] == res["jax"]
        assert res["port"][0] == {"volume": VID, "replication": "001"}
        assert res["port"][1][1] == 1  # the placement byte of the super block


def test_volume_copy_crosses_both_ways(tmp_path):
    with _twins(tmp_path) as tw:
        (jsrv, _), (psrv, _) = tw["jax"], tw["port"]
        jsrv.store.add_volume(21, collection=COLLECTION)
        _fill(jsrv, "jax", 21, 500, 40, T0 + 5, seed=21)
        psrv.store.add_volume(22, collection=COLLECTION)
        _fill(psrv, "port", 22, 700, 40, T0 + 7, seed=22)
        masters = {id(srv): master for srv, master in tw.values()}

        def dst_master(srv):
            return masters[id(srv)]

        replies = {}
        for dst, src, vid in ((psrv, jsrv, 21), (jsrv, psrv, 22)):
            r = http_json("POST", f"http://{_url(dst)}/admin/volume_copy?volume={vid}"
                                  f"&source={_url(src)}&collection={COLLECTION}")
            again = http_json("POST", f"http://{_url(dst)}/admin/volume_copy?volume={vid}"
                                      f"&source={_url(src)}&collection={COLLECTION}")
            replies[vid] = (r, again)
            for ext in (".dat", ".idx"):
                assert _file(dst, vid, ext) == _file(src, vid, ext), (vid, ext)
            assert _wait(lambda: _url(dst) in (dn.url() for dn in
                                               dst_master(dst).master.topo.lookup("", vid)))
        # the port's replies (it pulled 21) and the JAX server's (it pulled 22)
        for vid in (21, 22):
            assert replies[vid] == ({}, {"error": f"volume {vid} already here",
                                         "_status": 409})


def test_server_leave_drops_the_node_at_once(tmp_path):
    with _twins(tmp_path) as tw:
        res = {}
        for kind, (srv, master) in tw.items():
            assert len(master.master.topo.data_nodes()) == 1
            t0 = time.perf_counter()
            reply = http_json("POST", f"http://{_url(srv)}/admin/server_leave")
            gone = not master.master.topo.data_nodes() and not master._nodes
            res[kind] = (reply == {"left": _url(srv)}, gone, time.perf_counter() - t0 < 10)
            time.sleep(0.8)  # a late beat would register the node again
            res[kind] += (not master.master.topo.data_nodes(),)
        assert res["port"] == res["jax"] == (True, True, True, True)
        assert tw["port"][0]._hb_thread is not None and not tw["port"][0]._hb_thread.is_alive()


def test_backup_crosses_both_ways(tmp_path):
    """The port's backup of the JAX server and the JAX package's backup of
    the port server: a full pass, then 30 more needles and 5 deletes on both
    sources, then an incremental pass."""
    with _twins(tmp_path) as tw:
        (jsrv, jmaster), (psrv, pmaster) = tw["jax"], tw["port"]
        runs = {"port": (pbackup.backup_volume, jmaster, jsrv),
                "jax": (jbackup.backup_volume, pmaster, psrv)}
        res = {}
        for kind, (backup, master, _) in runs.items():
            d = str(tmp_path / f"backup-{kind}")
            res[kind] = [backup(master.url, VID, d, COLLECTION)]
        for kind in KINDS:
            _fill(tw[kind][0], kind, VID, 2000, 30, T0 + 50_000, seed=99)
        for kind, (backup, master, src) in runs.items():
            d = str(tmp_path / f"backup-{kind}")
            res[kind].append(backup(master.url, VID, d, COLLECTION))
            files = {}
            for ext in (".dat", ".idx"):
                with open(os.path.join(d, f"{COLLECTION}_{VID}{ext}"), "rb") as f:
                    files[ext] = f.read()
            assert files[".dat"] == _file(src, VID, ".dat")
            res[kind].append(files)
        for r in res.values():
            for run in r[:2]:
                run.pop("from")  # each names its own source server
        assert res["port"] == res["jax"]
        full, incr, _ = res["port"]
        assert full["start_offset"] == 0 and incr["start_offset"] > 0
        assert incr["writes"] == 30 and incr["deletes"] == 8


def test_vol_vacuum_compacts_on_a_port_only_cluster(tmp_path):
    """The repair: /vol/vacuum on the port's master over port servers
    compacts the volume above the threshold (it answered {"compacted": []}
    while the port's volume server lacked /admin/vacuum_check)."""
    master = PMasterServer(port=_free_port(), node_timeout=60).start()
    srv = PVolumeServer([str(tmp_path / "v")], port=_free_port(), master_url=master.url,
                        pulse_seconds=0.3, ec_backend="cpu").start()
    try:
        assert http_json("POST", f"http://{master.url}/vol/grow?collection=c&count=1") == \
            {"count": 1}
        vid = next(iter(srv.store.locations[0].volumes))
        rng = np.random.default_rng(7)
        blobs = {}
        for i in range(1, 61):
            fid = str(FileId(vid, i, 0x77000 + i))
            blobs[fid] = rng.bytes(int(rng.integers(1000, 20_000)))
            assert http_bytes("POST", f"http://{_url(srv)}/{fid}", body=blobs[fid])[0] == 201
        dead = list(blobs)[::2]
        for fid in dead:
            assert http_bytes("DELETE", f"http://{_url(srv)}/{fid}")[0] == 202
        before = srv.store.find_volume(vid).size()
        r = http_json("POST", f"http://{master.url}/vol/vacuum?garbageThreshold=0.3")
        assert r == {"compacted": [vid]}
        assert srv.store.find_volume(vid).size() < before
        for fid, data in blobs.items():
            status, body = http_bytes("GET", f"http://{_url(srv)}/{fid}")
            assert (status, body) == ((404, body) if fid in dead else (200, data)), fid
        dn = master.master.topo.data_nodes()[0]
        assert _wait(lambda: dn.volumes[vid].compact_revision == 1)
        # below the threshold now: a second vacuum compacts nothing
        assert http_json("POST", f"http://{master.url}/vol/vacuum?garbageThreshold=0.3") == \
            {"compacted": []}
    finally:
        srv.stop()
        master.stop()


def test_leave_joins_the_beat_before_notifying(tmp_path):
    """No beat lands after the leave: the master keeps the node out."""
    master = PMasterServer(port=_free_port(), node_timeout=60).start()
    srv = PVolumeServer([str(tmp_path / "v")], port=_free_port(), master_url=master.url,
                        pulse_seconds=0.1, ec_backend="cpu").start()
    try:
        assert _wait(lambda: len(master.master.topo.data_nodes()) == 1)
        stop = threading.Event()
        beats = []

        def churn():  # delta beats racing the leave
            while not stop.is_set():
                srv.store.delta_event.set()
                beats.append(1)
                time.sleep(0.01)

        t = threading.Thread(target=churn)
        t.start()
        try:
            http_json("POST", f"http://{_url(srv)}/admin/server_leave")
        finally:
            stop.set()
            t.join(timeout=5)
        time.sleep(0.5)
        assert not master.master.topo.data_nodes() and beats
    finally:
        srv.stop()
        master.stop()
