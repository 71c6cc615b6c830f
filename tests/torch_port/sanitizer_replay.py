"""Port-only replays of the JAX package's concurrency suites, for the
sanitizer cross-checks (``test_torch_lock_order.py``,
``test_torch_racecheck.py``).

Both packages name their locks alike (``"Volume._lock"``) and dump to the
same ``SWEED_*_DUMP`` path, so a cross-check child must never import the
JAX package. ``run_port_suites`` writes a copy of each named reference
suite (``tests/<name>.py``) into a scratch directory with every
``seaweedfs_tpu`` name swapped for ``seaweedfs_tpu_torch``, and runs those
copies under pytest in a child process with the sanitizer environment. The
child's ``conftest.py`` writes a side file at exit: the JAX-package and jax
modules it loaded (there must be none) and which of the port's
instrumented classes carry the race tracker's wrapper.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
REPO = os.path.dirname(TESTS)
PORT = os.path.join(REPO, "seaweedfs_tpu_torch")

_CONFTEST = '''
import json
import os
import sys

import pytest


@pytest.fixture(autouse=True)
def _fresh_http_pool():
    """Drop pooled keep-alive sockets between tests (ports get reused)."""
    yield
    from seaweedfs_tpu_torch.server import http_util

    conns = getattr(http_util._pool_local, "conns", None)
    if conns:
        for c in conns.values():
            c.close()
        conns.clear()


def pytest_unconfigure(config):
    from seaweedfs_tpu_torch.stats.metrics import Counter
    from seaweedfs_tpu_torch.util.aio_pipeline import ThreadFlume
    from seaweedfs_tpu_torch.util.needle_cache import NeedleCache

    with open(os.environ["SWEED_SIDE_FILE"], "w") as f:
        json.dump({
            "foreign": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("seaweedfs_tpu", "jax", "jaxlib")),
            "wrapped": sorted(c.__name__ for c in (Counter, ThreadFlume, NeedleCache)
                              if "__sweed_race_wrapped__" in vars(c)),
        }, f)
'''


def port_source(src: str) -> str:
    """A reference suite's source with the JAX package's names swapped for
    the port's; paths derived from the suite's own location point at the
    repository."""
    src = re.sub(r"\bseaweedfs_tpu\b(?!_torch)", "seaweedfs_tpu_torch", src)
    for pat in ("os.path.dirname(os.path.dirname(os.path.abspath(__file__)))",
                "os.path.dirname(os.path.dirname(__file__))"):
        src = src.replace(pat, repr(REPO))
    return src


def run_port_suites(workdir, names, env: dict, args=(), timeout: float = 150):
    """Run the port copies of ``tests/<name>.py`` under pytest in a child
    with ``env`` added. Returns ``(completed process, side file dict)``."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    files = []
    for name in names:
        with open(os.path.join(TESTS, f"{name}.py"), encoding="utf-8") as f:
            src = port_source(f.read())
        path = os.path.join(workdir, f"port_{name}.py")
        with open(path, "w", encoding="utf-8") as f:
            f.write(src)
        files.append(path)
    with open(os.path.join(workdir, "conftest.py"), "w", encoding="utf-8") as f:
        f.write(_CONFTEST)
    side = os.path.join(workdir, "side.json")
    child_env = dict(os.environ, PYTHONPATH=REPO, SWEED_SIDE_FILE=side, **env)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", *files, "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args],
        capture_output=True, text=True, env=child_env, cwd=workdir, timeout=timeout)
    info = {}
    if os.path.exists(side):
        with open(side, encoding="utf-8") as f:
            info = json.load(f)
    return r, info


def _port_project():
    from seaweedfs_tpu_torch.analysis import _iter_py_files
    from seaweedfs_tpu_torch.analysis.callgraph import Project

    proj = Project()
    for path, rel in _iter_py_files(PORT):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        proj.add_module(rel, ast.parse(src), src.splitlines())
    return proj


def static_edges() -> set:
    """The port analyzer's lock-order graph over ``seaweedfs_tpu_torch/``."""
    from seaweedfs_tpu_torch.analysis.lockgraph import compute_lock_graph

    return compute_lock_graph(_port_project()).edge_set()


def static_race_names() -> set:
    """The port analyzer's race candidate names over the port."""
    from seaweedfs_tpu_torch.analysis.racecheck import compute_race_report

    return {c.name for c in compute_race_report(_port_project())}
