"""The port stands alone: importing every module of ``seaweedfs_tpu_torch``
and ``chip_smoke.py`` loads neither jax nor any module of the JAX package,
and starts no thread (the servers start only when asked). Checked in a
fresh interpreter, since this test process imports both."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import importlib, importlib.util, os, pkgutil, sys, threading
sys.path.insert(0, REPO)
threads = threading.active_count()
import seaweedfs_tpu_torch
names = ["seaweedfs_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__, "seaweedfs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "seaweedfs_tpu" or m.startswith("seaweedfs_tpu."))
print("MODULES", len(names))
print("NAMES", ",".join(names))
print("BAD", bad)
print("NEW_THREADS", threading.active_count() - threads)
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", f"REPO = {REPO!r}\n" + PROBE],
                       capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    lines = dict(line.split(" ", 1) for line in r.stdout.splitlines() if " " in line)
    assert int(lines["MODULES"]) >= 20, r.stdout
    walked = set(lines["NAMES"].split(","))
    for name in ("cluster.sequence", "cluster.topology", "cluster.volume_layout",
                 "cluster.volume_growth", "cluster.master", "cluster.fleet",
                 "stats.histogram", "wdclient", "server.master_server",
                 "shell.commands", "shell.shell", "util.throttler",
                 "storage.volume_backup", "stats.metrics", "storage.turbo",
                 "server.aio", "server.status_ui", "util.aio_pipeline",
                 "util.needle_cache", "operation", "util.config", "util.safe_xml",
                 "s3api.xml_util", "s3api.s3_client", "storage.backend",
                 "storage.backend.core", "storage.backend.s3_backend",
                 "storage.backend.fake_s3", "storage.backend_config", "cluster.election",
                 "cluster.fid_lease", "cluster.lifecycle", "filer", "filer.entry",
                 "filer.filechunks", "filer.filechunk_manifest", "filer.filerstore",
                 "filer.abstract_sql", "filer.meta_log", "filer.filer_conf", "filer.filer",
                 "filer.meta_aggregator", "util.pipeline", "util.chunk_cache",
                 "util.cipher", "util.hedge", "util.compression", "query.select",
                 "server.aio_transport", "server.filer_server", "util.locks",
                 "util.racecheck", "util.deadline", "stats.trace", "security.tls",
                 "filer.client", "filer.ring", "s3api", "s3api.auth",
                 "s3api.policy_engine", "s3api.post_policy", "s3api.s3api_server",
                 "client", "client.fs", "ec.sharded", "ec.mesh_dryrun",
                 "storage.needle_map_dense", "messaging", "messaging.consistent",
                 "filer.reshard", "filer.redis_store", "filer.sdk_stores", "util.resp",
                 "util.mini_redis", "replication", "replication.notification",
                 "replication.sink", "replication.cloud_sinks", "replication.replicator",
                 "replication.filer_sync", "replication.controller", "mount",
                 "mount.dirty_pages", "mount.meta_cache", "mount.wfs", "mount.sync",
                 "mount.fuse_mount", "server.webdav_server", "server.ftp_server",
                 "messaging.log_buffer", "messaging.broker", "messaging.client",
                 "util.images", "util.netports", "util.glog", "util.profiling",
                 "analysis", "analysis.rules", "analysis.callgraph",
                 "analysis.lockgraph", "analysis.domaingraph", "analysis.racecheck",
                 "analysis.taint", "analysis.__main__", "__main__"):
        assert "seaweedfs_tpu_torch." + name in walked, name
    assert lines["BAD"] == "[]", r.stdout
    assert lines["NEW_THREADS"] == "0", r.stdout


def test_jax_factory_still_refuses_cuda():
    """The port registers nothing into the JAX package's codec factory."""
    import seaweedfs_tpu_torch.ec.codec  # noqa: F401
    from seaweedfs_tpu.ec.codec import _BACKENDS, get_codec

    assert "cuda" not in _BACKENDS
    with pytest.raises(ValueError):
        get_codec("cuda")


def test_engine_is_built_from_the_ports_own_source():
    """The volume server's engine is the port's ``csrc/turbo.cpp``, built
    into ``csrc/build/`` (never the JAX package's ``native/`` library), and
    it loads beside the JAX package's engine in one process without either
    binding the other's symbols."""
    from seaweedfs_tpu.native import turbo as jturbo
    from seaweedfs_tpu_torch.storage import turbo as pturbo

    port_src = os.path.join(REPO, "seaweedfs_tpu_torch", "csrc", "turbo.cpp")
    assert pturbo.SOURCE == port_src
    with open(port_src) as f:
        assert "#include" in f.read()
    lib = pturbo.load()
    assert lib is not None, pturbo.load_error()
    built = pturbo.library_path()
    assert os.path.dirname(built) == os.path.join(REPO, "seaweedfs_tpu_torch", "csrc", "build")
    assert pturbo.build() == built  # the same source and flags: no rebuild
    assert jturbo._load() is not None
    assert os.path.realpath(jturbo._SO) != os.path.realpath(built)
    # the two engines run side by side, each answering its own counters
    a = lib.turbo_start(b"127.0.0.1", 0, b"127.0.0.1", 1, 1)
    b = jturbo._load().turbo_start(b"127.0.0.1", 0, b"127.0.0.1", 1, 1)
    try:
        assert a and b and a != b
    finally:
        lib.turbo_stop(a)
        jturbo._load().turbo_stop(b)
