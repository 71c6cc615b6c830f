"""The benchmark never loads JAX or the JAX package, and its reference and
load generator never load the program."""

import ast
import os
import subprocess
import sys

from conftest import ROOT, SEED, copy_root

BENCH = os.path.join(ROOT, "swbench")
JAX = {"jax", "jaxlib", "flax", "seaweedfs_tpu"}


def _imports(path: str) -> set:
    """Top-level names of every module a file imports (the part before
    the first dot, whole), relative imports left out."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _files(sub: str = "") -> list:
    top = os.path.join(BENCH, sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


def test_no_file_imports_jax_or_the_jax_package():
    found = {p: _imports(p) & JAX for p in _files()}
    assert not {p: names for p, names in found.items() if names}
    # whole names: the port's package begins with the JAX package's name
    assert "seaweedfs_tpu_torch" in _imports(os.path.join(BENCH, "cluster.py"))


def test_reference_and_load_generator_import_nothing_of_the_program():
    program = {"seaweedfs_tpu_torch", "torch"}
    for p in _files("reference") + _files("gen") + [os.path.join(BENCH, "clients.py"),
                                                    os.path.join(BENCH, "loads.py")]:
        assert not _imports(p) & program, p
    assert not _imports(os.path.join(BENCH, "reference", "rs.py")) - {"__future__", "numpy"}


def test_nothing_of_smoke_or_the_old_bench_is_used():
    for p in _files():
        assert not _imports(p) & {"chip_smoke", "bench"}, p


def test_cpu_run_leaves_no_jax_module(tmp_path):
    """A dry run of a cell on the CPU, in a process of its own, then its
    sys.modules."""
    root = copy_root(str(tmp_path / "checkout"))
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from swbench import harness\n"
        f"line = harness.run_cell(harness.Spec({root!r}), 'ec-seal-rebuild', {SEED}, 1.0,"
        " False, time.monotonic(), device='cpu')\n"
        "assert line['correct'], line\n"
        "print('LOADED', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_no_card_no_result(tmp_path):
    """Without the CUDA devices a cell asks for, run.py exits non-zero and
    prints no result line; it never falls back to the CPU."""
    out = subprocess.run([sys.executable, "swbench/run.py", "--workload", "ec-seal-rebuild",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and swbench/, the harness
    cannot start the program: non-zero, no result."""
    root = copy_root(str(tmp_path / "alone"), small=False)
    code = ("import sys\nsys.path.insert(0, '.')\n"
            "from swbench import cluster\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "seaweedfs_tpu_torch" in out.stderr
