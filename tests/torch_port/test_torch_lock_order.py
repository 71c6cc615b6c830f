"""The port's lock-order sanitizer (``seaweedfs_tpu_torch/util/locks.py``)
held against the JAX package's, and the static ⊇ dynamic cross-check on
the port.

- The unit cases of ``tests/test_lock_order.py``, on the port's
  ``OrderedLock``.
- A seeded script of acquisitions over eight lock names, run through both
  packages' ``OrderedLock``: the same steps raise ``LockOrderError``, and
  the two ``lock_stats()`` are equal.
- The port's lock names (``make_lock``/``make_rlock``) and ``@instrument``
  classes cover the JAX package's.
- The cross-check: port-only copies of the reference's concurrency suites
  (concurrent vacuum, election quorum, messaging) run in a child under
  ``SWEED_LOCK_CHECK=1``: no inversion, and every observed edge is in the
  port analyzer's static graph over ``seaweedfs_tpu_torch/``.
"""

from __future__ import annotations

import ast
import json
import os
import random
import threading

import pytest

from seaweedfs_tpu.util import locks as jlocks
from seaweedfs_tpu_torch.util import locks as plocks
from seaweedfs_tpu_torch.util.locks import (
    LockOrderError,
    OrderedLock,
    lock_stats,
    make_condition,
    make_lock,
    make_rlock,
    observed_edges,
    reset_observed,
)

from sanitizer_replay import PORT, REPO, run_port_suites, static_edges

REFERENCE = os.path.join(REPO, "seaweedfs_tpu")


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_observed()
    jlocks.reset_observed()
    yield
    reset_observed()
    jlocks.reset_observed()


# -- unit: ordering (tests/test_lock_order.py) --------------------------------

def test_inversion_raises_before_blocking():
    a = OrderedLock("A._lock")
    b = OrderedLock("B._lock")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(LockOrderError):
            a.acquire()


def test_consistent_order_is_silent():
    a = OrderedLock("A._lock")
    b = OrderedLock("B._lock")
    for _ in range(3):
        with a:
            with b:
                pass
    assert observed_edges() == [("A._lock", "B._lock")]


def test_same_name_edges_not_recorded():
    v1 = OrderedLock("Volume._lock")
    v2 = OrderedLock("Volume._lock")
    with v1:
        with v2:
            pass
    assert observed_edges() == []


def test_transitive_cycle_detected():
    a, b, c = (OrderedLock(n) for n in ("A._lock", "B._lock", "C._lock"))
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with pytest.raises(LockOrderError):
            a.acquire()


def test_rlock_reentrancy_is_not_an_edge():
    r = OrderedLock("R._lock", "rlock")
    with r:
        with r:
            assert r.locked()
    assert observed_edges() == []
    assert not r.locked()


def test_nonblocking_acquire_failure_keeps_stack_clean():
    lk = OrderedLock("X._lock")
    lk.acquire()
    result = {}

    def try_it():
        result["got"] = lk.acquire(blocking=False)

    t = threading.Thread(target=try_it)
    t.start()
    t.join()
    assert result["got"] is False
    lk.release()
    assert lock_stats()["per_lock"]["X._lock"]["contended"] == 1


@pytest.mark.parametrize("kind", ["lock", "rlock"])
def test_condition_wait_releases_and_restores(kind):
    """``make_condition`` over an ``OrderedLock`` of either kind: wait()
    gives the lock up and takes it back, and the registry sees the
    re-acquired lock as held."""
    lk = OrderedLock("MetaLog._lock", kind)
    cond = make_condition(lk)
    ready = threading.Event()
    done = []

    def waiter():
        with cond:
            ready.set()
            cond.wait(timeout=5)
            with OrderedLock("Leaf._lock"):
                done.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    ready.wait(5)
    with cond:
        cond.notify()
    t.join(5)
    assert done == [True]
    assert ("MetaLog._lock", "Leaf._lock") in observed_edges()
    assert not lk.locked()


def test_stats_counters():
    a = OrderedLock("A._lock")
    b = OrderedLock("B._lock")
    with a:
        with b:
            pass
    s = lock_stats()
    assert s["acquisitions"] == 2
    assert s["max_held_depth"] == 2
    assert s["per_lock"]["A._lock"]["acquisitions"] == 1


def test_factories_return_plain_locks_when_disabled(monkeypatch):
    monkeypatch.delenv("SWEED_LOCK_CHECK", raising=False)
    assert not isinstance(make_lock("A._lock"), OrderedLock)
    assert not isinstance(make_rlock("A._lock"), OrderedLock)
    assert lock_stats()["enabled"] is False


def test_factories_return_ordered_locks_when_enabled(monkeypatch):
    monkeypatch.setenv("SWEED_LOCK_CHECK", "1")
    lk = make_lock("A._lock")
    assert isinstance(lk, OrderedLock)
    assert isinstance(make_rlock("B._lock"), OrderedLock)
    assert isinstance(make_condition(lk), threading.Condition)
    assert lock_stats()["enabled"] is True


def test_dump_at_exit_writes_the_observed_graph(tmp_path, monkeypatch):
    dump = tmp_path / "dump.json"
    monkeypatch.setenv("SWEED_LOCK_CHECK", "1")
    monkeypatch.setenv("SWEED_LOCK_DUMP", str(dump))
    with OrderedLock("A._lock"):
        with OrderedLock("B._lock"):
            pass
    plocks._dump_at_exit()
    snap = json.loads(dump.read_text())
    assert snap["edges"] == ["A._lock -> B._lock"]
    assert snap["edge_sites"]["A._lock -> B._lock"].startswith("test_torch_lock_order.py:")
    assert snap["acquisitions"] == 2


# -- parity with the JAX package's sanitizer ----------------------------------

NAMES = ["Master._lock", "Topology._lock", "VolumeLayout._lock", "Store._lock",
         "Volume._lock", "DiskFile._lock", "Histogram._lock", "MetaLog._lock"]


def _script(seed: int, steps: int = 400):
    """Seeded nested acquisitions (depth 1-4, each lock of either kind),
    so some steps close a cycle in the order observed so far."""
    rng = random.Random(seed)
    kinds = {n: rng.choice(("lock", "rlock")) for n in NAMES}
    return kinds, [rng.sample(NAMES, rng.randint(1, 4)) for _ in range(steps)]


def _replay(mod, kinds, script):
    locks = {n: mod.OrderedLock(n, kinds[n]) for n in NAMES}
    raised = []
    for i, names in enumerate(script):
        held = []
        try:
            for n in names:
                locks[n].acquire()
                held.append(locks[n])
        except mod.LockOrderError as e:
            raised.append((i, len(held), str(e).split(" (")[0]))
        finally:
            for lk in reversed(held):
                lk.release()
    return raised, mod.lock_stats(), mod.observed_edges()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_script_raises_and_counts_alike(seed):
    kinds, script = _script(seed)
    p_raised, p_stats, p_edges = _replay(plocks, kinds, script)
    j_raised, j_stats, j_edges = _replay(jlocks, kinds, script)
    assert p_raised and p_raised == j_raised
    assert p_stats == j_stats and p_stats["acquisitions"] > 0
    assert p_edges == j_edges


# -- lock names and instrumented classes cover the JAX package's --------------

def _names_and_classes(root):
    names, classes = set(), set()
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "analysis")]
        for fn in files:
            if not fn.endswith(".py") or fn in ("locks.py", "racecheck.py"):
                continue
            with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id in ("make_lock", "make_rlock") and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    names.add(node.args[0].value)
                if isinstance(node, ast.ClassDef) and any(
                        isinstance(d, ast.Name) and d.id == "instrument"
                        for d in node.decorator_list):
                    classes.add(node.name)
    return names, classes


def test_port_lock_names_and_instrumented_classes_cover_the_reference():
    ref_names, ref_classes = _names_and_classes(REFERENCE)
    port_names, port_classes = _names_and_classes(PORT)
    assert len(ref_names) >= 40 and len(ref_classes) == 17
    assert ref_names <= port_names, sorted(ref_names - port_names)
    assert ref_classes <= port_classes, sorted(ref_classes - port_classes)
    # the port's own locks follow the naming convention too
    assert {"Store._codec_lock", "gf_matmul._lib_lock", "gf_matmul._count_lock"} <= port_names


# -- cross-check: static ⊇ dynamic on the port --------------------------------

def test_concurrency_suites_under_sanitizer_cross_check(tmp_path):
    dump = tmp_path / "lockdump.json"
    r, side = run_port_suites(
        tmp_path / "suites",
        ["test_concurrent_vacuum", "test_election_quorum", "test_messaging"],
        {"SWEED_LOCK_CHECK": "1", "SWEED_LOCK_DUMP": str(dump)})
    assert r.returncode == 0, (
        "port suites failed under SWEED_LOCK_CHECK=1 (lock-order inversion?):\n"
        + r.stdout[-4000:] + r.stderr[-2000:])
    assert side["foreign"] == [], side
    snap = json.loads(dump.read_text())
    assert snap["enabled"] is True
    assert snap["acquisitions"] > 0
    dynamic = {tuple(e.split(" -> ")) for e in snap["edges"]}
    assert dynamic, "no lock nesting observed"
    missing = dynamic - static_edges()
    assert not missing, (
        f"observed lock-order edges missing from the static graph: {sorted(missing)}; "
        f"first sites: { {k: v for k, v in snap['edge_sites'].items() if tuple(k.split(' -> ')) in missing} }")
