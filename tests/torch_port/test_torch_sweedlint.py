"""sweedlint over the port (``seaweedfs_tpu_torch/analysis``): the JAX
package's rule fixtures replayed on the port's analyzer, parity of the two
analyzers, and the port's own gate.

- The cases of ``tests/test_sweedlint.py`` run on the port's analyzer over
  the reference's fixtures (read from ``tests/fixtures/sweedlint/``, never
  copied). The collective pair is the one exception: the port knows
  ``torch.distributed`` collectives, not ``jax.lax`` ones, so its cases run
  on a torch twin of each fixture (``jax.lax.psum`` → ``dist.all_reduce``,
  on the same lines).
- Parity: on every fixture both analyzers report the same ``(rule, path,
  line, message)`` list; over the JAX package's tree they compute the same
  lock-order edges and the same race candidates.
- The gate: the port's CLI over ``seaweedfs_tpu_torch/`` is clean against
  ``tests/torch_port/sweedlint_baseline.json``, with no stale waiver.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from seaweedfs_tpu import analysis as j_analysis
from seaweedfs_tpu.analysis import callgraph as j_callgraph
from seaweedfs_tpu.analysis import lockgraph as j_lockgraph
from seaweedfs_tpu.analysis import racecheck as j_racecheck
from seaweedfs_tpu_torch import analysis as p_analysis
from seaweedfs_tpu_torch.analysis import analyze_file, analyze_paths
from seaweedfs_tpu_torch.analysis import callgraph as p_callgraph
from seaweedfs_tpu_torch.analysis import lockgraph as p_lockgraph
from seaweedfs_tpu_torch.analysis import racecheck as p_racecheck

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "fixtures", "sweedlint")
PORT = os.path.join(REPO, "seaweedfs_tpu_torch")
REFERENCE = os.path.join(REPO, "seaweedfs_tpu")
BASELINE = os.path.join(HERE, "sweedlint_baseline.json")

# (rule, fixture stem, relpath the scoped rules need to see): the
# reference's table (tests/test_sweedlint.py CASES)
CASES = [
    ("lock-discipline", "lock_discipline", "storage/fixture.py"),
    ("durability", "durability", "storage/fixture.py"),
    ("strict-int", "strict_int", "server/fixture.py"),
    ("broad-except", "broad_except", "server/fixture.py"),
    ("resource-leak", "resource_leak", "server/fixture.py"),
    ("bounded-window", "bounded_window", "server/fixture.py"),
    ("unbounded-retry", "unbounded_retry", "server/fixture.py"),
    ("lock-order", "lock_order", "cluster/fixture.py"),
    ("blocking-under-lock", "blocking_under_lock", "storage/fixture.py"),
    ("blocking-on-loop", "blocking_on_loop", "server/fixture.py"),
    ("collective-under-lock", "collective_under_lock", "server/fixture.py"),
    ("tainted-size", "tainted_size", "server/fixture.py"),
    ("resource-leak", "ncache_populate", "server/fixture.py"),
    ("lock-discipline", "ncache_shard", "storage/fixture.py"),
    ("metric-cardinality", "metric_cardinality", "server/fixture.py"),
    ("maintenance-without-interlock", "maintenance_without_interlock",
     "cluster/fixture.py"),
    ("blocking-on-loop", "native_bridge", "server/fixture.py"),
    ("lock-order", "asyncio_lock_order", "cluster/fixture.py"),
    ("cross-domain-race", "cross_domain_race", "server/fixture.py"),
    ("lock-held-across-await", "lock_held_across_await", "server/fixture.py"),
    ("loop-affine-escape", "loop_affine_escape", "server/fixture.py"),
    ("deadline-not-propagated", "deadline_not_propagated", "server/fixture.py"),
]
COLLECTIVE = "collective_under_lock"


def _torch_twin(path: str, tmp_path) -> str:
    """The collective fixture with its jax collective swapped for a
    torch.distributed one, line for line."""
    src = open(path, encoding="utf-8").read()
    twin = (src.replace("import jax\n", "import torch.distributed as dist\n")
            .replace('jax.lax.psum(bits, "tp")', "dist.all_reduce(bits)"))
    assert twin.count("\n") == src.count("\n") and "jax" not in twin.split('"""', 2)[2]
    out = tmp_path / os.path.basename(path)
    out.write_text(twin)
    return str(out)


def _fixture(stem: str, kind: str, tmp_path) -> str:
    path = os.path.join(FIXTURES, f"{stem}_{kind}.py")
    return _torch_twin(path, tmp_path) if stem == COLLECTIVE else path


@pytest.mark.parametrize("rule,stem,rel", CASES, ids=[c[0] for c in CASES])
def test_rule_fires_exactly_once_on_bad_fixture(rule, stem, rel, tmp_path):
    found = analyze_file(_fixture(stem, "bad", tmp_path), rel)
    assert [v.rule for v in found] == [rule], found


@pytest.mark.parametrize("rule,stem,rel", CASES, ids=[c[0] for c in CASES])
def test_suppression_silences_ok_fixture(rule, stem, rel, tmp_path):
    found = analyze_file(_fixture(stem, "ok", tmp_path), rel)
    assert found == [], found


@pytest.mark.parametrize("rule,stem,rel", CASES, ids=[c[0] for c in CASES])
def test_suppressing_a_different_rule_does_not_waive(rule, stem, rel, tmp_path):
    src = open(_fixture(stem, "ok", tmp_path)).read()
    other = "lock-discipline" if rule != "lock-discipline" else "durability"
    src = src.replace(f"sweedlint: ok {rule}", f"sweedlint: ok {other}")
    p = tmp_path / f"{stem}_cross.py"
    p.write_text(src)
    found = analyze_file(str(p), rel)
    assert [v.rule for v in found] == [rule], found


def test_reasonless_suppression_does_not_count(tmp_path):
    src = open(os.path.join(FIXTURES, "broad_except_ok.py")).read()
    src = src.replace(
        "# sweedlint: ok broad-except best-effort poll; the next tick retries",
        "# sweedlint: ok broad-except",
    )
    p = tmp_path / "reasonless.py"
    p.write_text(src)
    found = analyze_file(str(p), "server/fixture.py")
    assert [v.rule for v in found] == ["broad-except"], found


CORNER_CASES = [
    ("callgraph_inherited", "blocking-under-lock"),
    ("callgraph_decorated", "blocking-under-lock"),
    ("callgraph_aliased_import", "blocking-under-lock"),
    ("callgraph_await", "blocking-on-loop"),
    ("callgraph_async_inherited", "blocking-on-loop"),
    ("callgraph_async_decorated", "blocking-on-loop"),
]


@pytest.mark.parametrize("stem,rule", CORNER_CASES, ids=[c[0] for c in CORNER_CASES])
def test_callgraph_corner_case_fires_exactly_once(stem, rule):
    found = analyze_file(os.path.join(FIXTURES, f"{stem}_bad.py"), "storage/fixture.py")
    assert [v.rule for v in found] == [rule], found


def test_locked_suffix_callee_reports_only_at_its_own_site():
    found = analyze_file(os.path.join(FIXTURES, "locked_suffix_ok.py"), "storage/fixture.py")
    assert found == [], found


def test_stale_waiver_fires_on_dead_suppression():
    found = analyze_file(os.path.join(FIXTURES, "stale_waiver_bad.py"),
                         "storage/fixture.py", audit_waivers=True)
    assert [v.rule for v in found] == ["stale-waiver"], found


def test_live_waiver_passes_the_audit():
    found = analyze_file(os.path.join(FIXTURES, "stale_waiver_ok.py"),
                         "storage/fixture.py", audit_waivers=True)
    assert found == [], found


def test_analyze_paths_audits_waivers(tmp_path):
    d = tmp_path / "storage"
    d.mkdir()
    (d / "thing.py").write_text(
        "def f(x):\n"
        "    # sweedlint: ok durability nothing here ever renamed anything\n"
        "    return x\n"
    )
    found = analyze_paths([str(d)])
    assert [v.rule for v in found] == ["stale-waiver"], found


def test_module_level_sanitizer_lock_is_a_graph_node():
    """A module-level ``make_lock("mod._x")`` is the node its name says,
    here and where it is imported, so a class lock held around it makes an
    edge (the port's kernel wrapper counts launches under such a lock)."""
    proj = p_callgraph.Project()
    for rel, src in (
        ("ec/counter.py",
         "from ..util.locks import make_lock\n"
         "_count_lock = make_lock(\"counter._count_lock\")\n"
         "def bump():\n"
         "    with _count_lock:\n"
         "        pass\n"),
        ("storage/owner.py",
         "import threading\n"
         "from ..ec.counter import bump, _count_lock\n"
         "class Owner:\n"
         "    def __init__(self):\n"
         "        self._lock = threading.Lock()\n"
         "    def work(self):\n"
         "        with self._lock:\n"
         "            bump()\n"
         "    def direct(self):\n"
         "        with self._lock:\n"
         "            with _count_lock:\n"
         "                pass\n"),
    ):
        proj.add_module(rel, ast.parse(src), src.splitlines())
    assert p_lockgraph.compute_lock_graph(proj).edge_set() == {
        ("Owner._lock", "counter._count_lock")}


# -- parity with the JAX package's analyzer -----------------------------------

FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))
_REL = {stem: rel for _r, stem, rel in CASES}


def _rel_for(name: str) -> str:
    stem = name[:-3].rsplit("_", 1)[0]
    return _REL.get(stem, "storage/fixture.py")


def _key(found):
    return [(v.rule, v.path, v.line, v.message) for v in found]


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_both_analyzers_agree_on_every_fixture(name, tmp_path):
    path = os.path.join(FIXTURES, name)
    rel = _rel_for(name)
    for audit in (False, True):
        ref = j_analysis.analyze_file(path, rel, audit_waivers=audit)
        port = p_analysis.analyze_file(path, rel, audit_waivers=audit)
        if name.startswith(COLLECTIVE):
            # the one rule whose input differs: the port's collectives are
            # torch.distributed's. Its twin gives the port's finding at the
            # JAX fixture's line.
            twin = p_analysis.analyze_file(_torch_twin(path, tmp_path), rel,
                                           audit_waivers=audit)
            assert [(v.rule, v.line) for v in twin] == [(v.rule, v.line) for v in ref]
            assert all("torch.distributed.all_reduce" in v.message for v in twin)
            continue
        assert _key(port) == _key(ref), (name, audit)


def _project(mod, root):
    proj = mod.Project()
    for path, rel in j_analysis._iter_py_files(root):
        src = open(path, encoding="utf-8").read()
        proj.add_module(rel, ast.parse(src), src.splitlines())
    return proj


def test_both_analyzers_agree_over_the_reference_tree():
    """Equal lock-order edges and equal race candidates over
    ``seaweedfs_tpu/`` (which calls no torch.distributed collective)."""
    ref_edges = j_lockgraph.compute_lock_graph(_project(j_callgraph, REFERENCE)).edge_set()
    port_edges = p_lockgraph.compute_lock_graph(_project(p_callgraph, REFERENCE)).edge_set()
    assert ref_edges and port_edges == ref_edges
    ref_race = sorted((c.name, sorted(c.domains), repr(c.sites))
                      for c in j_racecheck.compute_race_report(_project(j_callgraph, REFERENCE)))
    port_race = sorted((c.name, sorted(c.domains), repr(c.sites))
                       for c in p_racecheck.compute_race_report(_project(p_callgraph, REFERENCE)))
    assert ref_race and port_race == ref_race


def test_collective_under_lock_knows_torch_distributed(tmp_path):
    """Every torch.distributed collective and process-group call, called as
    ``dist.X``, ``torch.distributed.X`` or an imported name, fires under a
    lock; the same calls outside it do not; jax.lax ones do not fire."""
    names = sorted(p_lockgraph._COLLECTIVE_NAMES | p_lockgraph._PROCESS_GROUP_NAMES)
    lines = ["import threading", "import torch", "import torch.distributed as dist",
             "from torch.distributed import all_reduce", "import jax", "",
             "class Member:", "    def __init__(self):",
             "        self._lock = threading.Lock()", "", "    def step(self, t):",
             "        with self._lock:"]
    want = []
    for n in names:
        lines.append(f"            dist.{n}(t)")
        want.append(len(lines))
        lines.append(f"            torch.distributed.{n}(t)")
        want.append(len(lines))
    lines.append("            all_reduce(t)")
    want.append(len(lines))
    lines.append("            jax.lax.psum(t, 'tp')")
    lines += ["", "    def free(self, t):"] + [f"        dist.{n}(t)" for n in names]
    p = tmp_path / "member.py"
    p.write_text("\n".join(lines) + "\n")
    found = analyze_file(str(p), "server/fixture.py")
    assert [(v.rule, v.line) for v in found] == [("collective-under-lock", n) for n in want]


# -- the port's gate and CLI --------------------------------------------------

_BAD = "import os\n\ndef f(b):\n    os.replace(b + '.cpd', b + '.dat')\n"
_GIT = ["git", "-c", "user.name=t", "-c", "user.email=t@t", "-c", "init.defaultBranch=main"]


def _cli(*args, **kw):
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=300, **kw)


def test_gate_port_is_clean_against_its_baseline(tmp_path):
    """The CLI over the whole port (its default path) finds no violation
    beyond the port's baseline, no stale baseline entry and no stale
    waiver, and writes the SARIF document."""
    out = tmp_path / "sweedlint.sarif"
    r = _cli("--baseline", BASELINE, "--sarif-out", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0"
    assert doc["runs"][0]["tool"]["driver"]["name"] == "sweedlint"
    assert doc["runs"][0]["results"] == []
    with open(BASELINE) as f:
        assert json.load(f) == []


def test_port_waivers_are_all_live():
    r = _cli("--waivers", "--json", PORT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr
    inv = json.loads(r.stdout)["waivers"]
    assert inv and all(w["status"] == "LIVE" and w["reason"] for w in inv)
    assert all(w["path"].startswith("seaweedfs_tpu_torch/") for w in inv)


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "storage"
    bad.mkdir()
    (bad / "thing.py").write_text(_BAD)
    r = _cli(str(bad))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "durability" in r.stdout
    good = tmp_path / "clean"
    good.mkdir()
    (good / "thing.py").write_text("x = 1\n")
    r = _cli(str(good))
    assert r.returncode == 0, r.stdout + r.stderr
    r = _cli("--changed", "HEAD", str(good))
    assert r.returncode == 2  # --changed and paths are exclusive


def test_cli_sarif_output(tmp_path):
    bad = tmp_path / "storage"
    bad.mkdir()
    (bad / "thing.py").write_text(_BAD)
    r = _cli("--sarif", str(bad))
    assert r.returncode == 1, r.stdout + r.stderr
    results = json.loads(r.stdout)["runs"][0]["results"]
    assert [res["ruleId"] for res in results] == ["durability"]
    loc = results[0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("thing.py")
    assert loc["region"]["startLine"] == 4


@pytest.fixture
def scratch_repo(tmp_path):
    """A git repository holding a copy of the port's analyzer (the CLI
    finds the repository from its own package), committed."""
    import shutil

    repo = tmp_path / "repo"
    shutil.copytree(os.path.join(PORT, "analysis"), repo / "seaweedfs_tpu_torch" / "analysis")
    (repo / "seaweedfs_tpu_torch" / "__init__.py").write_text("")
    subprocess.run(_GIT + ["init", "-q", str(repo)], check=True)
    subprocess.run(["git", "add", "-A"], cwd=repo, check=True)
    subprocess.run(_GIT + ["commit", "-q", "-m", "base"], cwd=repo, check=True)
    return repo


def _changed(repo):
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.analysis", "--changed",
                           "HEAD"], capture_output=True, text=True, cwd=repo, timeout=120)


def test_cli_changed_mode_smoke(scratch_repo):
    """--changed HEAD analyzes the diff against HEAD: empty right after a
    commit, so the run is clean."""
    r = _changed(scratch_repo)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "sweedlint: clean" in r.stdout


def test_cli_changed_keeps_port_paths(scratch_repo):
    """``--changed`` lints the port's changed files, never the JAX
    package's: with one violating file added under each package, only the
    port's is reported."""
    for pkg in ("seaweedfs_tpu", "seaweedfs_tpu_torch"):
        d = scratch_repo / pkg / "storage"
        d.mkdir(parents=True)
        (d / "thing.py").write_text(_BAD)
    subprocess.run(["git", "add", "-A"], cwd=scratch_repo, check=True)
    r = _changed(scratch_repo)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "seaweedfs_tpu_torch/storage/thing.py:4: [durability]" in r.stdout
    assert "seaweedfs_tpu/storage" not in r.stdout


def test_cli_waivers_audit_lists_live_and_stale(tmp_path):
    d = tmp_path / "storage"
    d.mkdir()
    (d / "thing.py").write_text(
        "import os\n"
        "\n"
        "def f(b):\n"
        "    # sweedlint: ok durability tmp artifact; torn state impossible\n"
        "    os.replace(b + '.cpd', b + '.dat')\n"
        "def g(x):\n"
        "    # sweedlint: ok durability nothing here renames anything\n"
        "    return x\n"
    )
    r = _cli("--waivers", str(d))
    assert r.returncode == 1, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert any(ln.startswith("LIVE") and "thing.py:4" in ln for ln in lines), r.stdout
    assert any(ln.startswith("STALE") and "thing.py:7" in ln for ln in lines), r.stdout
    assert "2 waiver(s), 1 stale" in r.stdout
    r = _cli("--waivers", "--json", str(d))
    doc = json.loads(r.stdout)
    assert [(w["line"], w["status"]) for w in doc["waivers"]] == [(4, "LIVE"), (7, "STALE")]
    r = _cli("--waivers", "--changed", "HEAD")
    assert r.returncode == 2  # the audit needs the whole project


def test_cli_sarif_out_writes_artifact(tmp_path):
    bad = tmp_path / "storage"
    bad.mkdir()
    (bad / "thing.py").write_text(_BAD)
    out = tmp_path / "artifacts" / "sweedlint.sarif"
    r = _cli(str(bad), "--sarif-out", str(out))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "durability" in r.stdout
    doc = json.loads(out.read_text())
    assert [res["ruleId"] for res in doc["runs"][0]["results"]] == ["durability"]
