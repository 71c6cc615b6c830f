"""ThreadSanitizer pass over the port's native engine (``csrc/turbo.cpp``).

``csrc/tsan_harness.cpp`` (the port's copy of the JAX package's harness)
links the port's engine under ``-fsanitize=thread`` and races HTTP workers,
the Python-delegation C API, stats readers and a readonly toggler on one
volume for about 3 s. ``storage.turbo.build_tsan_harness`` builds it into
``csrc/build/`` at first use. TSan makes the process exit non-zero on any
race it sees. Gated, as the reference's test is, on a compiler that
accepts ``-fsanitize=thread``.
"""

import importlib.util
import os
import re
import subprocess
import sys

import pytest

from seaweedfs_tpu_torch.storage import turbo

from sanitizer_replay import TESTS

_spec = importlib.util.spec_from_file_location("ref_test_tsan", os.path.join(TESTS, "test_tsan.py"))
_ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ref)


def _signature(head: str, params: str):
    """(return type and name, parameter types) of a C declaration, the
    parameters' own names dropped."""
    types = [re.sub(r"\s*\b\w+$", "", " ".join(p.split())) for p in params.split(",")]
    return " ".join(head.split()), [t.replace(" *", "*") for t in types]


def test_harness_calls_only_entry_points_the_port_exports():
    """Every engine function the harness declares is defined by the port's
    engine with the same return and parameter types."""
    with open(turbo.TSAN_SOURCE) as f:
        harness = f.read()
    with open(turbo.SOURCE) as f:
        engine = f.read()
    decls = harness.split('extern "C" {', 1)[1].split("}", 1)[0]
    found = re.findall(r"([\w ]+?\b(turbo_\w+))\(([^)]*)\);", decls)
    assert {n for _h, n, _p in found} >= {"turbo_start", "turbo_append", "turbo_lookup",
                                         "turbo_set_readonly"}
    for head, name, params in found:
        m = re.search(r"\n([\w ]+?\b%s)\(([^)]*)\)\s*\{" % name, engine)
        assert m, name
        assert _signature(*m.groups()) == _signature(head, params), name


def test_turbo_engine_race_free_under_tsan(tmp_path):
    if not _ref._tsan_toolchain_ok():
        pytest.skip("CXX -fsanitize=thread unavailable")
    exe = turbo.build_tsan_harness()
    assert exe.startswith(turbo.BUILD_DIR) and os.access(exe, os.X_OK)
    assert turbo.build_tsan_harness() == exe  # built once, then reused
    tsan_opts = (os.environ.get("TSAN_OPTIONS", "") + " halt_on_error=0 history_size=7").strip()
    run = subprocess.run([exe, str(tmp_path)], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, TSAN_OPTIONS=tsan_opts))
    sys.stderr.write(run.stderr[-500:])
    assert "WARNING: ThreadSanitizer" not in run.stderr, run.stderr[-3000:]
    assert run.returncode == 0, f"rc={run.returncode}: {run.stderr[-2000:]}"
    assert "harness done" in run.stderr
