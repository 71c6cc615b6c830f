"""The port's cross-domain race detector: its domain classification
(``analysis/domaingraph.py``), its lockset write tracker
(``util/racecheck.py``) and the dynamic ⊆ static cross-check on the port.

- The cases of ``tests/test_racecheck.py``, on the port's ``domaingraph``,
  ``racecheck`` and ``instrument``.
- The seeded race fixture (``tests/fixtures/sweedlint/cross_domain_race_bad.py``)
  is caught by both halves, and both packages' trackers record the same
  observations for the same writes.
- The cross-check: port-only copies of the reference's serving, QoS and
  lifecycle suites run in a child under ``SWEED_RACE_CHECK=1`` and
  ``SWEED_LOCK_CHECK=1``: every observed location is in the port analyzer's
  static candidate set over ``seaweedfs_tpu_torch/``.
"""

from __future__ import annotations

import ast
import asyncio
import json
import os
import threading

import pytest

from seaweedfs_tpu.util import racecheck as jrt
from seaweedfs_tpu_torch.analysis.callgraph import Project
from seaweedfs_tpu_torch.analysis.domaingraph import BACKGROUND, HANDLER, LOOP, compute_domains
from seaweedfs_tpu_torch.analysis.racecheck import compute_race_report
from seaweedfs_tpu_torch.util import racecheck as rt
from seaweedfs_tpu_torch.util.locks import OrderedLock

from sanitizer_replay import TESTS, run_port_suites, static_race_names

FIXDIR = os.path.join(TESTS, "fixtures", "sweedlint")


def _project(src: str, relpath: str = "server/fixture.py") -> Project:
    proj = Project()
    proj.add_module(relpath, ast.parse(src), src.splitlines())
    return proj


def _domains(src: str):
    return compute_domains(_project(src))


@pytest.fixture(autouse=True)
def _fresh_observations():
    rt.reset_observed()
    jrt.reset_observed()
    yield
    rt.reset_observed()
    jrt.reset_observed()


# -- domain classification corner cases ---------------------------------------

def test_run_in_executor_target_is_handler():
    dg = _domains(
        "def work():\n"
        "    pass\n"
        "async def route(loop, pool):\n"
        "    await loop.run_in_executor(pool, work)\n"
    )
    assert dg.domains_of("server.fixture.work") == frozenset({HANDLER})
    assert dg.domains_of("server.fixture.route") == frozenset({LOOP})


def test_copy_context_run_bridge_unwraps_to_real_target():
    dg = _domains(
        "from contextvars import copy_context\n"
        "def work():\n"
        "    pass\n"
        "async def route(loop, pool):\n"
        "    await loop.run_in_executor(pool, copy_context().run, work)\n"
    )
    assert dg.domains_of("server.fixture.work") == frozenset({HANDLER})


def test_inline_ctx_run_stays_in_calling_domain():
    dg = _domains(
        "from contextvars import copy_context\n"
        "def work():\n"
        "    pass\n"
        "def pump(ctx):\n"
        "    ctx.run(work)\n"
        "def start(self):\n"
        "    import threading\n"
        "    threading.Thread(target=pump).start()\n"
    )
    assert dg.domains_of("server.fixture.work") == frozenset({BACKGROUND})


def test_flume_producer_and_loop_consumer_make_put_multi_domain():
    src = (
        "import threading\n"
        "class Flume:\n"
        "    def put(self, item):\n"
        "        self.item = item\n"
        "class Pump:\n"
        "    def __init__(self):\n"
        "        self.flume = Flume()\n"
        "    def start(self):\n"
        "        threading.Thread(target=self._produce).start()\n"
        "    def _produce(self):\n"
        "        self.flume.put(1)\n"
        "    async def consume(self):\n"
        "        self.flume.put(0)\n"
    )
    dg = _domains(src)
    assert dg.domains_of("server.fixture.Flume.put") == frozenset({BACKGROUND, LOOP})
    assert "Flume.item" in {c.name for c in compute_race_report(_project(src))}


def test_lambda_thread_target_callees_are_background():
    dg = _domains(
        "import threading\n"
        "def work(n):\n"
        "    pass\n"
        "def start():\n"
        "    threading.Thread(target=lambda: work(3)).start()\n"
    )
    assert dg.domains_of("server.fixture.work") == frozenset({BACKGROUND})


def test_handler_method_and_async_def_roots():
    dg = _domains(
        "class H:\n"
        "    def _h_status(self):\n"
        "        helper()\n"
        "async def tick():\n"
        "    helper()\n"
        "def helper():\n"
        "    pass\n"
    )
    assert dg.domains_of("server.fixture.helper") == frozenset({HANDLER, LOOP})
    assert dg.label("server.fixture.helper") == "multi(handler+loop)"


def test_module_lock_guards_a_global_by_its_sanitizer_name():
    """A global written under a module-level ``make_lock`` from two domains
    is guarded: no race candidate."""
    src = (
        "import threading\n"
        "from ..util.locks import make_lock\n"
        "_mu = make_lock(\"fixture._mu\")\n"
        "_n = 0\n"
        "def bump():\n"
        "    global _n\n"
        "    with _mu:\n"
        "        _n += 1\n"
        "def start():\n"
        "    threading.Thread(target=bump).start()\n"
        "async def tick():\n"
        "    bump()\n"
    )
    assert compute_race_report(_project(src)) == []


# -- runtime tracker: zero overhead when disabled ------------------------------

def test_instrument_is_identity_when_disabled(monkeypatch):
    monkeypatch.delenv("SWEED_RACE_CHECK", raising=False)

    class C:
        pass

    assert rt.instrument(C) is C
    assert "__setattr__" not in vars(C)
    assert not hasattr(C, "__sweed_race_wrapped__")


def test_production_classes_carry_no_wrapper_when_disabled():
    """With SWEED_RACE_CHECK unset when the port was imported (this
    process), its instrumented classes keep an untouched __setattr__."""
    if os.environ.get("SWEED_RACE_CHECK") == "1":
        pytest.skip("this process runs under the race tracker")
    from seaweedfs_tpu_torch.cluster.topology import Topology
    from seaweedfs_tpu_torch.stats.metrics import Counter
    from seaweedfs_tpu_torch.util.aio_pipeline import ThreadFlume
    from seaweedfs_tpu_torch.util.needle_cache import NeedleCache

    for cls in (ThreadFlume, NeedleCache, Counter, Topology):
        assert "__setattr__" not in vars(cls), cls.__name__
        assert not hasattr(cls, "__sweed_race_wrapped__"), cls.__name__


# -- runtime tracker: enabled-path semantics -----------------------------------

def test_sanitizer_observes_unlocked_cross_domain_write(monkeypatch):
    monkeypatch.setenv("SWEED_RACE_CHECK", "1")

    @rt.instrument
    class Seeded:
        def __init__(self):
            self.total = 0

    s = Seeded()
    s.total = 1

    async def bump():
        s.total += 1

    asyncio.run(bump())
    obs = {o["name"]: o for o in rt.observations()}
    assert "Seeded.total" in obs
    assert set(obs["Seeded.total"]["domains"]) == {rt.BACKGROUND, rt.LOOP}


def test_sanitizer_single_domain_writes_stay_silent(monkeypatch):
    monkeypatch.setenv("SWEED_RACE_CHECK", "1")

    @rt.instrument
    class Solo:
        def __init__(self):
            self.n = 0

    s = Solo()
    for _ in range(3):
        s.n += 1
    assert rt.observations() == []


def test_sanitizer_common_lock_suppresses_observation(monkeypatch):
    monkeypatch.setenv("SWEED_RACE_CHECK", "1")
    mu = OrderedLock("Guarded._mu")

    @rt.instrument
    class Guarded:
        pass

    g = Guarded.__new__(Guarded)
    with mu:
        g.total = 1

    async def bump():
        with mu:
            g.total = 2

    asyncio.run(bump())
    assert rt.observations() == []


def test_sanitizer_domain_probes(monkeypatch):
    monkeypatch.setenv("SWEED_RACE_CHECK", "1")
    assert rt.current_domain() == rt.BACKGROUND
    seen = []
    t = threading.Thread(target=lambda: seen.append(rt.current_domain()),
                         name=rt.HANDLER_THREAD_PREFIX + "-probe")
    t.start()
    t.join()
    assert seen == [rt.HANDLER]

    async def probe():
        return rt.current_domain()

    assert asyncio.run(probe()) == rt.LOOP


def test_dump_at_exit_writes_observations(tmp_path, monkeypatch):
    dump = tmp_path / "race.json"
    monkeypatch.setenv("SWEED_RACE_CHECK", "1")
    monkeypatch.setenv("SWEED_RACE_DUMP", str(dump))

    @rt.instrument
    class Shared:
        pass

    s = Shared()
    s.x = 1

    async def write():
        s.x = 2

    asyncio.run(write())
    rt._dump_at_exit()
    assert json.loads(dump.read_text()) == {
        "observations": [{"name": "Shared.x", "domains": ["background", "loop"], "count": 1}]}


# -- the seeded race: one fixture caught by both halves, in both packages ------

def _drive_fixture(mod, monkeypatch):
    src = open(os.path.join(FIXDIR, "cross_domain_race_bad.py"), encoding="utf-8").read()
    monkeypatch.setenv("SWEED_RACE_CHECK", "1")
    ns: dict = {}
    exec(compile(src, "cross_domain_race_bad.py", "exec"), ns)
    gauge = mod.instrument(ns["Gauge"])()
    t = threading.Thread(target=gauge._drain, daemon=True)
    t.start()
    t.join()
    asyncio.run(gauge.serve())
    return src, mod.observations()


def test_seeded_race_fixture_caught_statically_and_dynamically(monkeypatch):
    src, observed = _drive_fixture(rt, monkeypatch)
    static = {c.name for c in compute_race_report(_project(src, "server/cross_domain_race_bad.py"))}
    assert "Gauge.total" in static
    dynamic = {o["name"] for o in observed}
    assert "Gauge.total" in dynamic
    assert dynamic <= static
    # the JAX package's tracker records the same observations
    _src, j_observed = _drive_fixture(jrt, monkeypatch)
    assert j_observed == observed


# -- dynamic ⊆ static over the port's suites -----------------------------------

def test_serving_suites_sanitizer_dynamic_subset_of_static(tmp_path):
    dump = tmp_path / "racedump.json"
    lock_dump = tmp_path / "lockdump.json"
    r, side = run_port_suites(
        tmp_path / "suites", ["test_serving", "test_qos", "test_lifecycle"],
        {"SWEED_RACE_CHECK": "1", "SWEED_LOCK_CHECK": "1",
         "SWEED_RACE_DUMP": str(dump), "SWEED_LOCK_DUMP": str(lock_dump)},
        args=("-k", "not bench_probe"))
    assert r.returncode == 0, (
        "port serving suites failed under SWEED_RACE_CHECK=1:\n"
        + r.stdout[-4000:] + r.stderr[-2000:])
    assert side["foreign"] == [], side
    # the tracker was on: the instrumented classes carry its wrapper
    assert side["wrapped"] == ["Counter", "NeedleCache", "ThreadFlume"], side
    assert json.loads(lock_dump.read_text())["acquisitions"] > 0
    observed = {o["name"] for o in json.loads(dump.read_text())["observations"]}
    missing = observed - static_race_names()
    assert not missing, (
        f"observed cross-domain writes absent from the static candidate set: {sorted(missing)}")
