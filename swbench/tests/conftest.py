"""Tests of the benchmark (``python -m pytest swbench/tests -q``).

They run on the CPU: the cells at a size a test run holds, with the port's
``cpu`` codec and query backend. Tests that need the card are marked
``cuda`` and decide inside the test whether there is one.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# each cell at a size a test run holds
SMALL = {
    "ec-seal-rebuild": {"volume_bytes": 4 << 20, "slots": 2},
    "lineitem-q6-select": {"objects": 2, "object_bytes": 1 << 20, "make_workers": 2},
}
SECONDS = 2.0
SEED = 2**31 + 12345  # more than 32 signed bits hold, as the driver's seeds are


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside the test when "
                   "torch.cuda.is_available() is false")


def copy_root(dest: str, small: bool = True) -> str:
    """A checkout of the benchmark alone (BENCHMARK.json and swbench/) at
    ``dest``, its traffic cut to ``SMALL``."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "swbench"), os.path.join(dest, "swbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if small:
        with open(os.path.join(dest, "BENCHMARK.json")) as f:
            doc = json.load(f)
        for w in doc["workloads"]:
            path = os.path.join(dest, "swbench", "traffic", f"{w['traffic']}.json")
            with open(path) as f:
                t = json.load(f)
            t.update(SMALL.get(w["name"], {}))
            with open(path, "w") as f:
                json.dump(t, f)
    return dest


@pytest.fixture
def small_root(tmp_path):
    return copy_root(str(tmp_path / "checkout"))


def run_small(root: str, cell: str, trace: bool = False, control: bool = False, inject=None,
              seed: int = SEED) -> dict:
    """One run of ``cell`` on the CPU: the result line's object."""
    import time

    from swbench import harness

    return harness.run_cell(harness.Spec(root), cell, seed, SECONDS, trace, time.monotonic(),
                            device="cpu", control=control, inject=inject)
