"""The program under test, started in the benchmark's own process.

The port's master and volume servers run here, so the profiler sees every
kernel they launch; the load comes from worker processes
(``swbench/clients.py``). ``Cluster.stop`` ends every server and worker it
started, and waits for each.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import time

from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

from .clients import Worker


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(url: str, method: str, path: str, body: bytes = b"") -> tuple:
    """(status, body) of one request on a fresh connection."""
    conn = http.client.HTTPConnection(url, timeout=600)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def admin(url: str, path: str) -> dict:
    status, data = http_call(url, "POST", path)
    if status != 200:
        raise RuntimeError(f"POST {url}{path} answered {status}: {data[:300]!r}")
    return json.loads(data)


def until(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.05)


class Cluster:
    """The master, the volume servers and the workers of one run."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.master = None
        self.servers: dict = {}  # url -> VolumeServer, live ones
        self.dirs: dict = {}  # url -> data directory
        self.workers: list = []

    def start_master(self) -> str:
        c = self.ctx.config["cluster"]
        self.master = MasterServer(host="127.0.0.1", port=free_port(),
                                   node_timeout=c["node_timeout_s"]).start()
        return self.master.url

    def start_volume_servers(self, n: int) -> list:
        c = self.ctx.config["cluster"]
        started = []
        for i in range(n):
            d = os.path.join(self.ctx.work, f"vs{i}")
            os.makedirs(d, exist_ok=True)
            vs = VolumeServer([d], host="127.0.0.1", port=free_port(),
                              master_url=self.master.url, pulse_seconds=c["pulse_s"],
                              max_volume_count=c["max_volumes"],
                              ec_backend=self.ctx.device)
            url = f"127.0.0.1:{vs.port}"
            self.servers[url], self.dirs[url] = vs, d
            vs.start()
            if vs.turbo is None:
                raise RuntimeError(f"volume server {url} runs without its native engine: "
                                   f"{vs.turbo_status()['reason']}")
            started.append(url)
        until(lambda: len(self.master.master.topo.data_nodes()) >= len(self.servers), 60,
              "the volume servers to register")
        return started

    def worker(self, task: str, **kwargs) -> Worker:
        w = Worker(task, **kwargs)
        self.workers.append(w)
        return w

    def stop(self) -> None:
        for w in self.workers:
            w.close()
        self.workers = []
        for url in list(self.servers):
            self.servers.pop(url).stop()
        if self.master is not None:
            self.master.stop()
            self.master = None
