"""Shared by the port's gateway tests (mount, FUSE, WebDAV, FTP, messaging):
a stack of either package's servers, and the replay of the reference's test
functions against the port.

A ``Stack`` is one master, one volume server and one filer of one package:
``Stack("port", ...)`` runs the port's (``ec_backend="cpu"``,
``query_backend="cpu"``), ``Stack("jax", ...)`` the JAX package's. Ports are
free ones, never fixed.

``replay(module, case, **fixtures)`` runs a reference test function with the
JAX package's names swapped for the port's: the names the reference module
imported at its top (``PORT_NAMES``: the gateways, the mount layer, the
broker, and the servers under them), and those its cases import in their
bodies (``LOCAL_IMPORTS``: the JAX module's attribute is swapped while the
case runs). The client side (``ftplib``, urllib, the JAX ``FilerClient``)
stays as it is, so the port's servers answer the reference's own requests.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import os
import threading
import time

import pytest
from s3_pair import REPO, cases, free_port, ref_module  # noqa: F401 — shared with the S3 replay

from seaweedfs_tpu_torch.messaging import Broker, ConsistentRing, MessagingClient
from seaweedfs_tpu_torch.messaging import client as p_msg_client
from seaweedfs_tpu_torch.messaging.log_buffer import LogBuffer, decode_messages, encode_message
from seaweedfs_tpu_torch.mount import WFS, ContinuousIntervals, MetaCache
from seaweedfs_tpu_torch.mount.fuse_mount import FuseMount, fuse_available
from seaweedfs_tpu_torch.mount.sync import MountSync, copy_from_filer, copy_to_filer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.ftp_server import FtpServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.server.webdav_server import WebDavServer

PORT_VOLUME = functools.partial(VolumeServer, ec_backend="cpu")
PORT_FILER = functools.partial(FilerServer, query_backend="cpu")

# the reference modules' top-level names, and the port's for them
PORT_NAMES = {
    "WFS": WFS, "ContinuousIntervals": ContinuousIntervals, "MetaCache": MetaCache,
    "MountSync": MountSync, "copy_to_filer": copy_to_filer, "copy_from_filer": copy_from_filer,
    "FuseMount": FuseMount, "fuse_available": fuse_available,
    "WebDavServer": WebDavServer, "FtpServer": FtpServer,
    "Broker": Broker, "ConsistentRing": ConsistentRing, "MessagingClient": MessagingClient,
    "LogBuffer": LogBuffer, "decode_messages": decode_messages, "encode_message": encode_message,
    "MasterServer": MasterServer, "VolumeServer": PORT_VOLUME, "FilerServer": PORT_FILER,
}
# (JAX module, name) that a reference case imports in its body
LOCAL_IMPORTS = {
    ("seaweedfs_tpu.mount.wfs", "WFS"): WFS,
    ("seaweedfs_tpu.mount.fuse_mount", "FuseMount"): FuseMount,
    ("seaweedfs_tpu.messaging.client", "partition_for_key"): p_msg_client.partition_for_key,
}


def can_mount() -> bool:
    """The reference's FUSE gate (``tests/test_fuse_mount.py``) on the
    port's probe: libfuse 2.x, ``/dev/fuse`` readable and writable, x86_64."""
    return fuse_available() and os.access("/dev/fuse", os.R_OK | os.W_OK)


def replay(module, case: str, **fixtures):
    """Run ``module.case`` on the port with the fixtures it asks for."""
    fn = getattr(module, case)
    params = inspect.signature(fn).parameters
    with pytest.MonkeyPatch.context() as mp:
        for name, obj in PORT_NAMES.items():
            if hasattr(module, name):
                mp.setattr(module, name, obj)
        for (mod, name), obj in LOCAL_IMPORTS.items():
            mp.setattr(importlib.import_module(mod), name, obj)
        return fn(**{n: fixtures[n] for n in params})


def _jax_classes():
    from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
    from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
    from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer

    return JMasterServer, JVolumeServer, JFilerServer


class Stack:
    """One package's master, volume server and filer (``url``: the filer's)."""

    def __init__(self, kind: str, tmp, chunk_size: int = 0, max_volume_count: int = 20):
        self.kind = kind
        if kind == "port":
            master_cls, volume_cls, filer_cls = MasterServer, PORT_VOLUME, PORT_FILER
        else:
            master_cls, volume_cls, filer_cls = _jax_classes()
        self.master = master_cls(port=free_port(), node_timeout=60).start()
        self.volume = volume_cls([str(tmp / f"{kind}-v")], port=free_port(),
                                 master_url=self.master.url, max_volume_count=max_volume_count,
                                 pulse_seconds=0.5).start()
        deadline = time.time() + 10
        while time.time() < deadline and not self.master.master.topo.data_nodes():
            time.sleep(0.05)
        kw = {"chunk_size": chunk_size} if chunk_size else {}
        self.filer = filer_cls(port=free_port(), master_url=self.master.url, **kw).start()
        self.extra: list = []  # gateways over this filer, stopped first

    @property
    def url(self) -> str:
        return self.filer.url

    def stop(self) -> None:
        servers = [*self.extra, self.filer, self.volume, self.master]
        if self.kind == "jax":
            # a JAX filer lingers ~10 s on an idle keep-alive peer when
            # stopped: stop its servers beside the rest of the teardown
            threading.Thread(target=lambda: [s.stop() for s in servers], daemon=True).start()
            return
        for s in servers:
            s.stop()
