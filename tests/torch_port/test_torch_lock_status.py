"""The lock counters in the port's ``/status`` and ``/metrics``, held
against the JAX package's.

- The port master's ``/dir/status`` has the JAX master's keys (``locks``
  and ``serving`` among them), and the port filer's ``/_status`` the JAX
  filer's plus its own ``query_routes``.
- ``/metrics`` of either port daemon has the four ``sweed_lock_*`` gauges,
  and their values are ``lock_stats()``'s.
- In a child that runs a port master, volume server and filer under
  ``SWEED_LOCK_CHECK=1`` (the sanitizer is decided when each lock is made,
  so the environment must be set before the servers start), a few writes
  and reads through the filer leave non-zero ``locks`` counters in both
  ``/status`` replies and in the gauges.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer as PFilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.util.locks import lock_stats

from sanitizer_replay import REPO

GAUGES = ("sweed_lock_acquisitions_total", "sweed_lock_contended_total",
          "sweed_lock_max_held_depth", "sweed_lock_order_edges")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gauges(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name in GAUGES:
            out[name] = float(value)
    return out


@pytest.fixture(scope="module")
def daemons():
    masters = {"jax": JMasterServer(port=free_port()).start(),
               "port": PMasterServer(port=free_port()).start()}
    murl = masters["port"].url
    filers = {"jax": JFilerServer(port=free_port(), master_url=murl, chunk_cache_mem_mb=0).start(),
              "port": PFilerServer(port=free_port(), master_url=murl, chunk_cache_mem_mb=0,
                                   query_backend="cpu").start()}
    time.sleep(0.3)
    yield masters, filers
    # the JAX package's asyncio server lingers on an idle keep-alive peer
    threading.Thread(target=filers["jax"].stop, daemon=True).start()
    filers["port"].stop()
    for m in masters.values():
        m.stop()


def test_master_status_has_the_reference_keys(daemons):
    masters, _ = daemons
    keys = {k: set(http_json("GET", f"http://{m.url}/dir/status"))
            for k, m in masters.items()}
    assert keys["port"] == keys["jax"]
    assert {"locks", "serving"} <= keys["port"]
    st = http_json("GET", f"http://{masters['port'].url}/dir/status")
    assert set(st["locks"]) == set(lock_stats())
    assert st["locks"]["enabled"] is False
    jst = http_json("GET", f"http://{masters['jax'].url}/dir/status")
    assert set(st["serving"]) == set(jst["serving"])


def test_filer_status_has_the_reference_keys(daemons):
    _, filers = daemons
    st = {k: http_json("GET", f"http://{f.url}/_status") for k, f in filers.items()}
    assert set(st["port"]) == set(st["jax"]) | {"query_routes"}
    assert set(st["port"]["locks"]) == set(st["jax"]["locks"])
    assert set(st["port"]["serving"]) == set(st["jax"]["serving"])


@pytest.mark.parametrize("which", ["master", "filer"])
def test_metrics_have_the_lock_gauges(daemons, which):
    masters, filers = daemons
    url = (masters if which == "master" else filers)["port"].url
    status, body = http_bytes("GET", f"http://{url}/metrics")
    assert status == 200
    got = _gauges(body.decode())
    assert set(got) == set(GAUGES)
    s = lock_stats()
    assert got["sweed_lock_order_edges"] == len(s["edges"])
    assert got["sweed_lock_max_held_depth"] == s["max_held_depth"]


CHILD = r"""
import json, sys, time
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.util.netports import free_port

d = sys.argv[1]
master = MasterServer(port=free_port()).start()
vol = VolumeServer([d + "/v"], port=free_port(), master_url=master.url, pulse_seconds=0.5,
                   ec_backend="cpu").start()
filer = FilerServer(port=free_port(), master_url=master.url, db_path=d + "/filer.db",
                    query_backend="cpu").start()
time.sleep(1.0)
for i in range(8):
    st, _ = http_bytes("POST", f"http://{filer.url}/locks/f{i}.bin", body=bytes([i]) * 5000)
    assert st < 300, st
for i in range(8):
    st, got = http_bytes("GET", f"http://{filer.url}/locks/f{i}.bin")
    assert st == 200 and got == bytes([i]) * 5000
out = {"master": http_json("GET", f"http://{master.url}/dir/status")["locks"],
       "filer": http_json("GET", f"http://{filer.url}/_status")["locks"],
       "metrics": http_bytes("GET", f"http://{master.url}/metrics")[1].decode()}
filer.stop(); vol.stop(); master.stop()
print("RESULT " + json.dumps(out))
"""


def test_lock_counters_move_under_the_sanitizer(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, SWEED_LOCK_CHECK="1")
    env.pop("SWEED_LOCK_DUMP", None)
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    for which in ("master", "filer"):
        locks = out[which]
        assert locks["enabled"] is True
        assert locks["acquisitions"] > 0 and locks["per_lock"], which
        assert locks["max_held_depth"] >= 1
    assert out["master"]["edges"], "no lock nesting in the stack"
    gauges = _gauges(out["metrics"])
    assert set(gauges) == set(GAUGES)
    assert gauges["sweed_lock_acquisitions_total"] > 0
    assert gauges["sweed_lock_order_edges"] >= 1
