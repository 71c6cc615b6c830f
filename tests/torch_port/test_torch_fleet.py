"""The port's fleet EC scheduler (``seaweedfs_tpu_torch.cluster.fleet``) and
the shell's ``ec.encode -fleet`` on a cluster made only of the port.

The scheduler cases are the JAX package's (``tests/test_fleet.py``) run on
the port's ``EcJobScheduler``; the port has no metrics registry yet, so the
retry case reads the scheduler's own job-latency histogram where the
reference reads its gauges. The cluster case mirrors
``test_shell_ec_encode_fleet_spreads_and_serves``: a port master, three port
volume servers (``cpu`` backend) and the port shell; the master schedules
the generate, the shell spreads the shards, and every needle reads back.
The shards must equal the JAX package's ``NumpyCodec`` encode of the same
.dat.
"""

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as jencoder
from seaweedfs_tpu.ec.codec import NumpyCodec
from seaweedfs_tpu_torch.cluster import fleet as fleet_mod
from seaweedfs_tpu_torch.cluster.fleet import EcJobScheduler, fleet_stats
from seaweedfs_tpu_torch.ec.constants import TOTAL_SHARDS, shard_ext
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ----------------------------------------------------- scheduler unit level
def test_scheduler_no_holder_fails_fast():
    sched = EcJobScheduler(locate=lambda vid: [], workers=1)
    try:
        jid = sched.submit("encode", 42)
        assert sched.wait([jid], timeout=10)
        job = sched.job_info(jid)
        assert job["state"] == "failed"
        assert "no live holder" in job["error"]
        st = sched.stats()
        assert st["jobs_failed"] == 1 and st["jobs_done"] == 0
    finally:
        sched.stop()


def test_scheduler_membership_and_aggregate_stats():
    sched = EcJobScheduler(locate=lambda vid: [], workers=1)
    try:
        sched.observe_member("10.0.0.1:8080", {"initialized": True})
        sched.observe_member("10.0.0.2:8080", {"initialized": False})
        assert set(sched.members()) == {"10.0.0.1:8080", "10.0.0.2:8080"}
        sched.drop_member("10.0.0.1:8080")
        assert set(sched.members()) == {"10.0.0.2:8080"}
        # the module-level snapshot the gauges read sees this scheduler
        agg = fleet_stats()
        assert agg["schedulers"] >= 1 and agg["members"] >= 1
    finally:
        sched.stop()
    assert sched not in fleet_mod._ACTIVE


def test_scheduler_bad_kind_rejected():
    sched = EcJobScheduler(locate=lambda vid: [], workers=1)
    try:
        with pytest.raises(ValueError):
            sched.submit("vacuum", 1)
    finally:
        sched.stop()


def test_scheduler_starts_workers_only_on_submit():
    before = threading.active_count()
    sched = EcJobScheduler(locate=lambda vid: [], workers=2)
    try:
        assert threading.active_count() == before
        jid = sched.submit("encode", 1)
        assert threading.active_count() == before + 2
        assert sched.wait([jid], timeout=10)
    finally:
        sched.stop()


# ------------------------------------------- retry / preemption semantics
def _stub_member(response=None, delay=0.0):
    """A fake volume server answering /admin/ec/* with a canned JSON body;
    returns (url, calls, shutdown)."""
    calls = []
    resp = response or {"shards": list(range(TOTAL_SHARDS)),
                        "bytes": 1000, "seconds": 0.5}

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            calls.append(self.path)
            if delay:
                time.sleep(delay)
            body = json.dumps(resp).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"127.0.0.1:{srv.server_port}", calls, srv.shutdown


def test_scheduler_retries_transport_failure_on_another_member():
    """A dead first holder (connection refused) costs one bounded-backoff
    retry, excluded from re-pick; the job completes on the live replica and
    the retry lands in the counters and gauges."""
    dead = f"127.0.0.1:{free_port()}"  # nothing listening: instant refusal
    live, calls, shutdown = _stub_member()
    sched = EcJobScheduler(
        locate=lambda vid: [dead, live], workers=1,
        max_attempts=3, retry_backoff_s=0.01,
    )
    try:
        jid = sched.submit("encode", 7)
        assert sched.wait([jid], timeout=30)
        job = sched.job_info(jid)
        assert job["state"] == "done", job
        assert job["server"] == live
        assert job["shards"] == list(range(TOTAL_SHARDS))
        assert calls, "live member never saw the retried dispatch"
        st = sched.stats()
        assert st["jobs_retried"] == 1 and st["jobs_preempted"] == 0
        assert st["job_latency"]["encode"]["count"] >= 2
    finally:
        shutdown()
        sched.stop()


def test_scheduler_attempt_cap_is_terminal():
    """All replicas dead: the job burns its attempt budget (one member
    excluded per try) and fails with the cap named — never an unbounded
    dispatch loop."""
    deads = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    sched = EcJobScheduler(
        locate=lambda vid: list(deads), workers=1,
        max_attempts=2, retry_backoff_s=0.01,
    )
    try:
        jid = sched.submit("encode", 9)
        assert sched.wait([jid], timeout=30)
        job = sched.job_info(jid)
        assert job["state"] == "failed", job
        assert "attempt cap 2" in job["error"], job
        st = sched.stats()
        assert st["jobs_retried"] == 1  # attempt 1 retried, attempt 2 terminal
    finally:
        sched.stop()


def test_scheduler_preempts_job_off_dropped_member():
    """drop_member mid-job re-queues the running job onto a survivor; the
    worker still blocked on the dead member's socket is fenced by the
    dispatch epoch when its stale response finally lands."""
    slow_resp = {"shards": [99], "bytes": 1, "seconds": 9.9}
    slow, slow_calls, slow_down = _stub_member(response=slow_resp, delay=3.0)
    fast, fast_calls, fast_down = _stub_member()
    sched = EcJobScheduler(
        locate=lambda vid: [slow, fast], workers=2,
        max_attempts=3, retry_backoff_s=0.01,
    )
    try:
        jid = sched.submit("encode", 11)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            job = sched.job_info(jid)
            if job["state"] == "running" and job["server"] == slow:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"job never dispatched to {slow}: {job}")
        sched.drop_member(slow)  # the reaper noticed the member died
        assert sched.wait([jid], timeout=30)
        job = sched.job_info(jid)
        assert job["state"] == "done", job
        assert job["server"] == fast
        assert job["shards"] == list(range(TOTAL_SHARDS))
        st = sched.stats()
        assert st["jobs_preempted"] == 1, st
        # the slow member's late answer must not clobber the settled job
        time.sleep(3.2)
        job = sched.job_info(jid)
        assert job["server"] == fast and job["shards"] != [99], job
    finally:
        slow_down()
        fast_down()
        sched.stop()


# -------------------------------------------- shell ec.encode -fleet path
def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


def _download(master_url, fid):
    vid = fid.split(",")[0]
    loc = http_json("GET", f"http://{master_url}/dir/lookup?volumeId={vid}")
    status, data = http_bytes("GET", f"http://{loc['locations'][0]['url']}/{fid}")
    assert status == 200, (fid, status)
    return data


def test_shell_ec_encode_fleet_spreads_and_serves(tmp_path):
    """`ec.encode -fleet` end to end on the port alone: the shell marks
    readonly, the master schedules the generate, the shell spreads and
    mounts the shards, and reads keep working."""
    master = MasterServer(port=free_port(), node_timeout=60).start()
    servers = [
        VolumeServer([str(tmp_path / f"srv{i}")], port=free_port(),
                     master_url=master.url, max_volume_count=10,
                     pulse_seconds=0.4, ec_backend="cpu").start()
        for i in range(3)
    ]
    try:
        env = CommandEnv(master.url)
        assert _wait(lambda: len(env.data_nodes()) == 3)

        rng = np.random.default_rng(5)
        vid, blobs, source = None, {}, None
        for _ in range(12):
            a = http_json("GET", f"http://{master.url}/dir/assign?collection=fleetc")
            v = int(a["fid"].split(",")[0])
            if vid is None:
                vid, source = v, a["url"]
            if v != vid:
                continue
            data = rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes()
            assert http_bytes("POST", f"http://{a['url']}/{a['fid']}", data)[0] == 201
            blobs[a["fid"]] = data
        assert blobs
        status, dat = http_bytes(
            "GET", f"http://{source}/admin/file?volume={vid}&collection=fleetc&ext=.dat")
        assert status == 200
        ref = tmp_path / "ref"
        ref.mkdir()
        (ref / f"fleetc_{vid}.dat").write_bytes(dat)
        jencoder.write_ec_files(str(ref / f"fleetc_{vid}"), NumpyCodec())

        # multiple ids without -fleet is an operator error, caught early
        with pytest.raises(ValueError):
            run_command(env, "ec.encode -volumeId=1,2 -collection=fleetc")

        res = run_command(env, f"ec.encode -volumeId={vid} -collection=fleetc -fleet")
        assert [v["volume"] for v in res["volumes"]] == [vid]
        assert all(j["state"] == "done" for j in res["jobs"])
        assert res["jobs"][0]["server"] == source

        assert _wait(lambda: len(env.ec_shard_locations(vid)) == TOTAL_SHARDS)
        by_shard = env.ec_shard_locations(vid)
        holders = {u for urls in by_shard.values() for u in urls}
        assert len(holders) == 3  # spread across the fleet, not one node
        for sid, urls in by_shard.items():
            status, got = http_bytes(
                "GET", f"http://{urls[0]}/admin/file?volume={vid}"
                       f"&collection=fleetc&ext={shard_ext(sid)}")
            assert status == 200
            assert got == (ref / f"fleetc_{vid}{shard_ext(sid)}").read_bytes(), sid
        for fid, want in blobs.items():
            assert _download(master.url, fid) == want

        st = http_json("GET", f"http://{master.url}/ec/fleet/status")
        assert st["jobs_done"] >= 1
        assert st["member_stats"][source]["bytes"] > 0
        dir_status = http_json("GET", f"http://{master.url}/dir/status")
        assert dir_status["fleet"]["jobs_done"] >= 1
        assert dir_status["assign"]["count"] == 12
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
