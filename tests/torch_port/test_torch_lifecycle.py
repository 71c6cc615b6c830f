"""The port's lifecycle controller (``cluster/lifecycle.py``), held against the
JAX package's.

The planner cases of the JAX package's ``tests/test_lifecycle.py`` run on
both packages: a simulated world (vid -> observation, bands recomputed each
cycle) and a fake executor that applies each action's effect, driven by
``tick()``. Then, on seeded random worlds and configurations (hypothesis),
both controllers plan and execute the same action lists cycle after cycle.
Last, a plan journal that one package left mid-action is recovered by the
other: the running action is re-validated and runs once, the planned ones
are abandoned, and a third incarnation finds the journal resolved.
"""

from __future__ import annotations

import copy
import dataclasses
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import seaweedfs_tpu.cluster.lifecycle as j_lc
import seaweedfs_tpu.cluster.volume_layout as j_layout
import seaweedfs_tpu.util.faultpoints as j_fp
import seaweedfs_tpu_torch.cluster.lifecycle as p_lc
import seaweedfs_tpu_torch.cluster.volume_layout as p_layout
import seaweedfs_tpu_torch.util.faultpoints as p_fp

PKG = {"jax": (j_lc, j_layout, j_fp), "port": (p_lc, p_layout, p_fp)}

# heat values against the default bands (floor 0.05, ceiling 50, tier 0.005)
HOT, WARM, COOL, COLD = 100.0, 1.0, 0.01, 0.001


@pytest.fixture(autouse=True)
def _default_bands(monkeypatch):
    for k in ("SWEED_HEAT_FLOOR", "SWEED_HEAT_CEILING", "SWEED_TIER_FLOOR",
              "SWEED_LIFECYCLE_BUDGETS"):
        monkeypatch.delenv(k, raising=False)


def make_vol(vid, heat=WARM, kind="plain", garbage=0.0, size=1000, tiered=False,
             replicas=("n1:8080",), corrupt_needles=None, corrupt_shards=None):
    return {
        "vid": vid, "collection": "", "kind": kind, "heat": heat, "garbage": garbage,
        "size": size, "replicas": list(replicas), "tiered": tiered, "read_only": False,
        "corrupt_needles": dict(corrupt_needles or {}),
        "ec_shards": {"n1:8080": list(range(14))} if kind == "ec" else {},
        "corrupt_shards": dict(corrupt_shards or {}),
    }


class World:
    """A mutable vid -> volume map the fake observe reads every cycle, with
    the bands computed as ``observe_topology`` does."""

    def __init__(self, layout, *vols):
        self.layout = layout
        self.vols = {v["vid"]: v for v in vols}

    def observe(self):
        obs = {}
        for vid, v in self.vols.items():
            ob = copy.deepcopy(v)
            ob["band"] = self.layout.classify_heat(ob["heat"])
            obs[vid] = ob
        return obs


class FakeOps:
    """Records each action and applies its effect to the world."""

    def __init__(self, world, fail=()):
        self.world = world
        self.executed = []
        self.fail = set(fail)

    def execute(self, action, ob):
        kind, vid = action["kind"], action["vid"]
        self.executed.append((kind, vid))
        if kind in self.fail:
            raise RuntimeError(f"injected {kind} failure")
        v = self.world.vols[vid]
        if kind == "ec":
            v["kind"], v["replicas"] = "ec", []
        elif kind == "un_ec":
            v["kind"], v["replicas"] = "plain", ["n1:8080"]
        elif kind == "tier_up":
            v["kind"], v["tiered"] = "plain", True
        elif kind == "tier_down":
            v["tiered"] = False
        elif kind == "vacuum":
            v["garbage"] = 0.0
        elif kind == "repair_shard":
            v["corrupt_shards"] = {}
        elif kind == "repair_replica":
            v["corrupt_needles"] = {}
        elif kind == "replica_boost":
            v["replicas"] = list(v["replicas"]) + ["n9:8080"]


class FakeInterlock:
    """Scripted verdicts: pops the next one, sticks on the last."""

    def __init__(self, *verdicts):
        self.verdicts = list(verdicts) or [True]
        self.fraction = 0.5
        self.last_reason = ""

    def maintenance_allowed(self):
        v = self.verdicts.pop(0) if len(self.verdicts) > 1 else self.verdicts[0]
        self.last_reason = "" if v else "scripted traffic peak"
        return v, self.last_reason


@pytest.fixture(params=list(PKG))
def pkg(request):
    return request.param


@pytest.fixture
def mk(pkg):
    """Controller factory of the parametrized package; stops (unregisters)
    every controller at teardown."""
    lc, layout, _ = PKG[pkg]
    made = []

    def build(*vols, cfg=None, ops=None, **kw):
        world = World(layout, *vols)
        kw.setdefault("interlock", FakeInterlock(True))
        c = lc.LifecycleController(config=cfg or lc.LifecycleConfig(), observe=world.observe,
                                   ops=ops or FakeOps(world), **kw)
        c.world = world
        made.append(c)
        return c

    build.lc = lc
    yield build
    for c in made:
        c.stop()


def cfg(mk, **kw):
    return mk.lc.LifecycleConfig(**kw)


# -- planning: the heat bands drive the transitions ---------------------------

def test_cooling_volume_ecs_exactly_once(mk):
    c = mk(make_vol(1, heat=COOL), cfg=cfg(mk, cold_streak=2, cooldown_cycles=2))
    for _ in range(6):
        c.tick()
    assert c.ops.executed == [("ec", 1)]
    assert c.world.vols[1]["kind"] == "ec"


def test_streak_gate_one_quiet_beat_is_not_cooling(mk):
    c = mk(make_vol(1, heat=COOL), cfg=cfg(mk, cold_streak=3))
    c.tick()
    c.world.vols[1]["heat"] = WARM
    for _ in range(5):
        c.tick()
    assert c.ops.executed == []


def test_reheated_ec_volume_un_ecs(mk):
    c = mk(make_vol(7, heat=HOT, kind="ec", replicas=()))
    c.tick()
    c.tick()
    assert c.ops.executed == [("un_ec", 7)]


@pytest.mark.parametrize("endpoint,want", [("127.0.0.1:9333", "tier_up"), ("", "ec")])
def test_cold_volume_tiers_or_ecs(mk, endpoint, want):
    c = mk(make_vol(3, heat=COLD), cfg=cfg(mk, cold_streak=1, tier_endpoint=endpoint))
    c.tick()
    assert c.ops.executed == [(want, 3)]


def test_tiered_volume_comes_home_when_warm(mk):
    c = mk(make_vol(4, heat=WARM, tiered=True), cfg=cfg(mk, tier_endpoint="127.0.0.1:9333"))
    c.tick()
    assert c.ops.executed == [("tier_down", 4)] and not c.world.vols[4]["tiered"]


def test_vacuum_above_garbage_threshold(mk):
    c = mk(make_vol(5, garbage=0.5), cfg=cfg(mk, garbage_threshold=0.3))
    c.tick()
    assert c.ops.executed == [("vacuum", 5)]


def test_repair_outranks_tiering(mk):
    c = mk(make_vol(1, heat=COLD),
           make_vol(2, kind="ec", replicas=(), corrupt_shards={"n1:8080": [3]}),
           cfg=cfg(mk, cold_streak=1, max_actions=1))
    c.tick()
    assert c.ops.executed == [("repair_shard", 2)]


def test_repair_replica_and_replica_boost(mk):
    c = mk(make_vol(6, replicas=("n1:8080", "n2:8080"), corrupt_needles={"n2:8080": 3}),
           make_vol(8, heat=HOT), cfg=cfg(mk, hot_replicas=2))
    c.tick()
    c.tick()
    assert c.ops.executed == [("repair_replica", 6), ("replica_boost", 8)]


def test_max_actions_and_budgets_bound_a_cycle(mk):
    budgets = {k: 0 for k in mk.lc.ACTION_KINDS} | {"ec": 2}
    c = mk(*[make_vol(v, heat=COOL) for v in range(1, 9)],
           cfg=cfg(mk, cold_streak=1, max_actions=4, budgets=budgets))
    c.tick()
    assert c.ops.executed == [("ec", 1), ("ec", 2)]


def test_cooldown_prevents_flapping(mk):
    c = mk(make_vol(5, garbage=0.9), cfg=cfg(mk, cooldown_cycles=3))
    c.tick()
    c.world.vols[5]["garbage"] = 0.9
    c.tick()
    c.tick()
    assert c.ops.executed == [("vacuum", 5)]
    c.tick()
    assert c.ops.executed == [("vacuum", 5), ("vacuum", 5)]


# -- interlocks ----------------------------------------------------------------

def test_interlock_defers_cycle_and_actions(mk):
    c = mk(make_vol(1, garbage=0.9), make_vol(2, garbage=0.9),
           interlock=FakeInterlock(False, True, True, False))
    s = c.tick()
    assert s["deferred"] and c.ops.executed == []
    c.tick()  # the cycle and the first action pass, the spike stops the second
    assert c.ops.executed == [("vacuum", 1)]
    counters = c.status()["counters"]
    assert (counters["cycles_deferred"], counters["actions_done"],
            counters["actions_deferred"]) == (1, 1, 1)


def test_pause_resume_and_admin_lock(mk):
    c = mk(make_vol(5, garbage=0.9))
    c.pause()
    assert c.tick()["deferred"] == "paused"
    c.resume()

    def held(_client):
        raise RuntimeError("admin lock held by operator@shell")

    c._lease = held
    assert "operator@shell" in c.tick()["locked"]
    c._lease = None
    c.tick()
    assert c.ops.executed == [("vacuum", 5)]
    assert c.status()["counters"]["cycles_skipped_locked"] == 1


def test_action_failure_does_not_kill_the_cycle(mk):
    world_vols = (make_vol(1, garbage=0.9), make_vol(2, garbage=0.9))
    c = mk(*world_vols)
    c.ops.fail = {"vacuum"}
    s = c.tick()
    assert [a["state"] for a in s["actions"]] == ["failed", "failed"]
    assert c.status()["counters"]["actions_failed"] == 2


def test_real_interlock_reads_the_serving_gauge(monkeypatch):
    """The port's LoadInterlock over its own admission gauge."""
    from seaweedfs_tpu_torch.server.http_util import SERVING

    class Busy:
        def inflight_count(self):
            return 600

    busy = Busy()
    saved = list(SERVING._servers)
    for s in saved:
        SERVING._servers.discard(s)
    SERVING.register_server(busy)
    try:
        monkeypatch.setenv("SWEED_MAX_INFLIGHT", "1000")
        allowed, reason = p_lc.LoadInterlock(fraction=0.5).maintenance_allowed()
        assert not allowed and "600" in reason
        monkeypatch.setenv("SWEED_MAX_INFLIGHT", "10000")
        assert p_lc.LoadInterlock(fraction=0.5).maintenance_allowed() == (True, "")
    finally:
        SERVING._servers.discard(busy)
        for s in saved:
            SERVING._servers.add(s)


def test_config_from_env_matches(monkeypatch):
    env = {"SWEED_LIFECYCLE_INTERVAL": "1.5", "SWEED_LIFECYCLE_COLD_STREAK": "2",
           "SWEED_LIFECYCLE_MAX_ACTIONS": "0", "SWEED_LIFECYCLE_COOLDOWN": "1",
           "SWEED_LIFECYCLE_GARBAGE": "0.25", "SWEED_LIFECYCLE_HOT_REPLICAS": "3",
           "SWEED_LIFECYCLE_LOAD_FRACTION": "junk", "SWEED_TIER_ENDPOINT": "http://h:1",
           "SWEED_TIER_BUCKET": "b", "SWEED_TIER_BACKEND": "s3.x",
           "SWEED_LIFECYCLE_BUDGETS": "ec=7, vacuum=0, bogus=9"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = p_lc.LifecycleConfig.from_env()
    assert dataclasses.asdict(got) == dataclasses.asdict(j_lc.LifecycleConfig.from_env())
    assert (got.max_actions, got.load_fraction, got.budgets["ec"], got.budgets["vacuum"]) == (
        1, 0.5, 7, 0)
    assert "bogus" not in got.budgets


def test_status_shape_and_stats(mk):
    before = mk.lc.lifecycle_stats()
    c = mk(make_vol(5, garbage=0.9))
    c.tick()
    after = mk.lc.lifecycle_stats()
    assert after["controllers"] == before["controllers"] + 1
    assert after["actions_done"] == before["actions_done"] + 1
    st_ = c.status()
    assert {"paused", "cycle", "counters", "interlock", "tier", "thresholds",
            "last_cycle", "cycle_latency", "action_latency"} <= set(st_)
    assert st_["thresholds"]["heat_floor"] == pytest.approx(0.05)


def test_metrics_expose_the_lifecycle_families(mk):
    from seaweedfs_tpu_torch.stats.metrics import default_registry

    c = mk(make_vol(5, garbage=0.9))
    c.tick()
    text = default_registry.expose()
    for name in ("sweed_lifecycle_controllers", "sweed_lifecycle_actions_done_total",
                 "sweed_lifecycle_recovered_resumed_total", "lifecycle_cycle_seconds_count",
                 'lifecycle_action_seconds_count{kind="vacuum"}'):
        assert name in text, name


# -- the same plans on seeded random worlds ------------------------------------

_vol = st.fixed_dictionaries({
    "heat": st.sampled_from([HOT, 20.0, WARM, 0.05, COOL, 0.005, COLD, 0.0]),
    "kind": st.sampled_from(["plain", "plain", "ec"]),
    "garbage": st.sampled_from([0.0, 0.1, 0.3, 0.6]),
    "size": st.sampled_from([0, 8, 1000]),
    "tiered": st.booleans(),
    "n_replicas": st.integers(0, 3),
    "corrupt_needles": st.integers(0, 2),
    "corrupt_shards": st.lists(st.integers(0, 13), max_size=2),
})


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(vols=st.lists(_vol, min_size=1, max_size=8),
       cold_streak=st.integers(1, 3), max_actions=st.integers(1, 5),
       cooldown=st.integers(0, 3), hot_replicas=st.integers(0, 3),
       tier=st.booleans(), ec_budget=st.integers(0, 3), cycles=st.integers(1, 6))
def test_plans_equal_across_packages(vols, cold_streak, max_actions, cooldown, hot_replicas,
                                     tier, ec_budget, cycles):
    results = []
    for lc, layout, _ in PKG.values():
        world = World(layout, *[
            make_vol(i + 1, heat=v["heat"], kind=v["kind"], garbage=v["garbage"],
                     size=v["size"], tiered=v["tiered"] and v["kind"] == "plain",
                     replicas=[f"n{r}:8080" for r in range(v["n_replicas"])],
                     corrupt_needles={f"n{r}:8080": 1 for r in range(
                         min(v["corrupt_needles"], v["n_replicas"]))},
                     corrupt_shards={"n1:8080": v["corrupt_shards"]} if v["corrupt_shards"]
                     else None)
            for i, v in enumerate(vols)])
        config = lc.LifecycleConfig(cold_streak=cold_streak, max_actions=max_actions,
                                    cooldown_cycles=cooldown, hot_replicas=hot_replicas,
                                    tier_endpoint="http://h:1" if tier else "")
        config.budgets["ec"] = ec_budget
        c = lc.LifecycleController(config=config, observe=world.observe, ops=FakeOps(world),
                                   interlock=FakeInterlock(True))
        try:
            plans = [c.tick()["actions"] for _ in range(cycles)]
        finally:
            c.stop()
        results.append((plans, c.ops.executed, world.vols))
    assert results[0] == results[1]


# -- a journal left mid-action, recovered by the other package -----------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_recovered_across_packages(tmp_path, writer, reader):
    journal = str(tmp_path / "lifecycle_9333.json")
    wlc, wlayout, wfp = PKG[writer]
    world = World(wlayout, make_vol(1, heat=COOL), make_vol(2, garbage=0.9),
                  make_vol(3, garbage=0.9))
    c = wlc.LifecycleController(journal_path=journal, observe=world.observe,
                                ops=FakeOps(world), interlock=FakeInterlock(True),
                                config=wlc.LifecycleConfig(cold_streak=1, max_actions=3))
    # the first action's "running" reaches the disk, then the master dies
    wfp.arm("lifecycle.journal.running", "io-error", count=1)
    try:
        with pytest.raises(OSError):
            c.tick()
    finally:
        wfp.reset()
        c.stop()
    assert c.ops.executed == []
    with open(journal) as f:
        doc = json.load(f)
    assert [(a["kind"], a["vid"], a["state"]) for a in doc["actions"]] == [
        ("vacuum", 2, "running"), ("vacuum", 3, "planned"), ("ec", 1, "planned")]

    rlc, rlayout, _ = PKG[reader]
    world = World(rlayout, make_vol(1, heat=WARM), make_vol(2, garbage=0.9),
                  make_vol(3, garbage=0.1))
    r = rlc.LifecycleController(journal_path=journal, observe=world.observe,
                                ops=FakeOps(world), interlock=FakeInterlock(True),
                                config=rlc.LifecycleConfig(cold_streak=99))
    try:
        r._recover()
        st_ = r.status()
        assert (st_["counters"]["resumed"], st_["counters"]["abandoned"]) == (1, 2)
        assert st_["recovery"]["cycle"] == doc["cycle"]
        s = r.tick()
        # the running vacuum is still needed and runs; the planned ones are
        # gone (the fresh observation no longer asks for them). In the same
        # cycle the JAX package's planner plans vacuum 2 afresh beside the
        # resumed one and runs it twice; the port's plans no volume that a
        # resumed action holds.
        want = [("vacuum", 2)] * (1 if reader == "port" else 2)
        assert r.ops.executed == want
        assert "[resumed]" in s["actions"][0]["detail"]
        r.tick()
        assert r.ops.executed == want
    finally:
        r.stop()
    with open(journal) as f:
        assert json.load(f)["state"] == "done"
    # a third incarnation (the writer's package) finds the journal resolved
    again = wlc.LifecycleController(journal_path=journal, observe=world.observe,
                                    ops=FakeOps(world), interlock=FakeInterlock(True))
    try:
        again._recover()
        assert again.status()["counters"]["resumed"] == 0
        assert again.status()["counters"]["abandoned"] == 0
    finally:
        again.stop()


@pytest.mark.parametrize("pkg_name", list(PKG))
def test_recovered_completed_action_is_a_noop(tmp_path, pkg_name):
    """The crash came after the move but before the journal said done: the
    volume is already EC, so the replay must not encode it again."""
    lc, layout, _ = PKG[pkg_name]
    journal = tmp_path / "lifecycle.json"
    journal.write_text(json.dumps({"cycle": 5, "state": "planned", "started": 0.0, "actions": [
        {"id": 1, "kind": "ec", "vid": 1, "collection": "", "state": "running", "error": "",
         "detail": ""}]}))
    world = World(layout, make_vol(1, heat=COOL, kind="ec", replicas=()))
    c = lc.LifecycleController(journal_path=str(journal), observe=world.observe,
                               ops=FakeOps(world), interlock=FakeInterlock(True),
                               config=lc.LifecycleConfig(cold_streak=99))
    try:
        c._recover()
        c.tick()
        assert c.ops.executed == [] and c.status()["counters"]["resumed"] == 1
        assert c.status()["cycle"] == 6  # the cycle count continues past the journal's
    finally:
        c.stop()


@pytest.mark.parametrize("pkg_name", list(PKG))
def test_corrupt_journal_is_tolerated(tmp_path, pkg_name):
    lc, layout, _ = PKG[pkg_name]
    journal = tmp_path / "lifecycle.json"
    journal.write_text("{torn")
    c = lc.LifecycleController(journal_path=str(journal),
                               observe=World(layout, make_vol(1)).observe,
                               ops=FakeOps(None), interlock=FakeInterlock(True))
    try:
        c._recover()
        assert c.status()["counters"]["resumed"] == 0
    finally:
        c.stop()


def test_repair_waits_for_the_master_to_see_the_drop(monkeypatch):
    """``repair_shard`` drops the corrupt shard, then ``ec.rebuild``
    rebuilds what the master lists as missing. The drop reaches the master
    by a delta beat: until then the master still lists the shard, and a
    rebuild asked at once (as the JAX package's is) finds nothing to do and
    the shard stays lost. The port asks only once the master no longer
    lists it."""
    calls = []
    stale = {"left": 3}  # the master lists the dropped shard for 3 more asks

    class Env:
        def ec_shard_locations(self, vid):
            calls.append("lookup")
            if stale["left"]:
                stale["left"] -= 1
                return {sid: ["n1:8080"] for sid in range(14)}
            return {sid: ["n1:8080"] for sid in range(14) if sid != 3}

    class Commands:
        @staticmethod
        def ec_rebuild(env, vid, collection):
            calls.append(("rebuild", vid, collection,
                          sorted(set(range(14)) - set(env.ec_shard_locations(vid)))))

    monkeypatch.setattr(p_lc, "http_json", lambda method, url: calls.append(url) or {})
    ops = p_lc.ClusterOps("m:9333", p_lc.LifecycleConfig())
    ops._env = Env()
    monkeypatch.setattr(ops, "_commands", lambda: (Commands, ops._env))
    ob = make_vol(7, kind="ec", replicas=(), corrupt_shards={"n1:8080": [3]})
    ob["collection"] = "col"
    ops.execute({"kind": "repair_shard", "vid": 7}, ob)
    assert calls[0] == "http://n1:8080/admin/ec/delete_shards?volume=7&shards=3"
    assert calls[1:5] == ["lookup"] * 4  # three stale answers, then the drop
    # the rebuild (asking once more itself) sees the shard missing
    assert calls[5:] == ["lookup", ("rebuild", 7, "col", [3])]
