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
                 "storage.volume_backup", "stats.metrics"):
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
