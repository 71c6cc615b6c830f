"""The port's master election (``cluster/election.py``), held against the
JAX package's.

The cases of the JAX package's ``tests/test_election_quorum.py`` and the
seeded partition fuzz of ``tests/test_election_fuzz.py`` run over an
in-process router (the ``_rpc`` hook), so partitions are instant and
deterministic. Every multi-node case runs on a mixed set: the port's and the
JAX package's ``LeaderElection`` side by side, which speak the same protocol.
The durable ``(term, voted_for)`` file one package writes, the other reads.
"""

import json
import random
import threading
import time

import pytest

from seaweedfs_tpu.cluster.election import LeaderElection as JElection
from seaweedfs_tpu_torch.cluster.election import LeaderElection as PElection

PACKAGES = {"jax": JElection, "port": PElection}


class SimNet:
    """An in-process router with a configurable partition."""

    def __init__(self):
        self.nodes = {}
        self.groups = None  # None: fully connected
        self.lock = threading.Lock()

    def reachable(self, a, b):
        with self.lock:
            return self.groups is None or any(a in g and b in g for g in self.groups)

    def partition(self, *groups):
        with self.lock:
            self.groups = [set(g) for g in groups]

    def heal(self):
        with self.lock:
            self.groups = None

    def rpc(self, src, peer, path, body):
        if not self.reachable(src, peer):
            raise ConnectionError(f"partitioned: {src} -/-> {peer}")
        node = self.nodes[peer]
        if path == "/cluster/leader_beat":
            return node.receive_beat(body["leader"], body["term"],
                                     body.get("max_file_key", 0), body.get("max_volume_id", 0))
        if path == "/cluster/vote":
            return node.receive_vote_request(
                body["candidate"], body["term"], body.get("max_file_key", 0),
                body.get("max_volume_id", 0), body.get("prevote", False))
        raise ValueError(path)


def make_node(net, url, urls, lease, cls, **kw):
    e = cls(url, urls, lease_seconds=lease, **kw)
    e._rpc = lambda peer, path, body, _u=url: net.rpc(_u, peer, path, body)
    net.nodes[url] = e
    return e


def make_cluster(net, n=3, lease=0.4):
    """m0, m2, ... on the port; m1, m3, ... on the JAX package."""
    urls = [f"m{i}:9333" for i in range(n)]
    nodes = [make_node(net, u, urls, lease, (PElection, JElection)[i % 2])
             for i, u in enumerate(urls)]
    for e in nodes:
        e.start()
    return urls, nodes


def wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.02)
    return None


def leaders(nodes):
    return [e for e in nodes if e.is_leader]


def stop_all(nodes):
    for e in nodes:
        e.stop()


def test_converges_to_single_leader():
    net = SimNet()
    urls, nodes = make_cluster(net)
    try:
        assert wait_for(lambda: len(leaders(nodes)) == 1)
        lead = leaders(nodes)[0]
        assert wait_for(lambda: all(e.leader == lead.self_url for e in nodes))
    finally:
        stop_all(nodes)


@pytest.mark.parametrize("victim", ["port", "jax"])
def test_minority_partitioned_leader_steps_down(victim):
    """The isolated leader (of either package) stops claiming leadership and
    the majority elects another; never two leaders."""
    net = SimNet()
    # the lowest url campaigns first: put the victim's package there
    urls = ["m0:9333", "m1:9333", "m2:9333"]
    first = PACKAGES[victim]
    other = JElection if first is PElection else PElection
    nodes = [make_node(net, u, urls, 0.4, cls) for u, cls in zip(urls, (first, other, first))]
    for e in nodes:
        e.start()
    try:
        assert wait_for(lambda: len(leaders(nodes)) == 1)
        old = leaders(nodes)[0]
        net.partition({old.self_url}, {u for u in urls if u != old.self_url})
        assert wait_for(lambda: not old.is_leader, timeout=5.0)
        assert wait_for(lambda: any(e.is_leader for e in nodes if e is not old), timeout=5.0)
        for _ in range(50):
            assert len(leaders(nodes)) <= 1
            time.sleep(0.01)
    finally:
        stop_all(nodes)


def test_heal_converges_without_dual_leader():
    net = SimNet()
    urls, nodes = make_cluster(net)
    try:
        assert wait_for(lambda: len(leaders(nodes)) == 1)
        old = leaders(nodes)[0]
        net.partition({old.self_url}, {u for u in urls if u != old.self_url})
        assert wait_for(lambda: not old.is_leader
                        and any(e.is_leader for e in nodes if e is not old), timeout=5.0)
        net.heal()

        def settled():
            ls = leaders(nodes)
            return len(ls) == 1 and all(e.leader == ls[0].self_url for e in nodes)

        assert wait_for(settled, timeout=5.0)
        for _ in range(50):
            assert len(leaders(nodes)) <= 1
            time.sleep(0.01)
    finally:
        stop_all(nodes)


def test_no_quorum_no_leader():
    """Two of three dead: the survivor (the port's) refuses to lead."""
    net = SimNet()
    urls, nodes = make_cluster(net)
    try:
        assert wait_for(lambda: len(leaders(nodes)) == 1)
        survivor = nodes[2]
        assert isinstance(survivor, PElection)
        net.partition({survivor.self_url}, {urls[0]}, {urls[1]})
        nodes[0].stop()
        nodes[1].stop()
        time.sleep(survivor.lease_seconds * 4)
        assert not survivor.is_leader
    finally:
        stop_all(nodes)


PEERS = ["m0:9333", "m1:9333", "m2:9333"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_one_vote_per_term(pkg):
    e = PACKAGES[pkg]("m0:9333", PEERS, lease_seconds=0.4)
    e._last_beat = time.time() - 10  # the lease has run out: votes are grantable
    assert e.receive_vote_request("m1:9333", 5, 100)["granted"]
    assert not e.receive_vote_request("m2:9333", 5, 100)["granted"]
    assert e.receive_vote_request("m2:9333", 6, 100)["granted"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_stale_candidate_denied(pkg):
    """A candidate behind on the sequence or the volume id cannot win."""
    e = PACKAGES[pkg]("m0:9333", PEERS, lease_seconds=0.4, get_max_file_key=lambda: 1000,
                      get_max_volume_id=lambda: 50)
    e._last_beat = time.time() - 10
    assert not e.receive_vote_request("m1:9333", 3, 500, max_volume_id=50)["granted"]
    assert not e.receive_vote_request("m1:9333", 4, 2000, max_volume_id=10)["granted"]
    assert e.receive_vote_request("m1:9333", 5, 2000, max_volume_id=50)["granted"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_restart_cannot_double_vote(tmp_path, writer, reader):
    """(term, voted_for) persisted by one package: a master restarted on the
    other refuses a second candidate in that term."""
    path = str(tmp_path / "election_9333.json")
    e = PACKAGES[writer]("m0:9333", PEERS, lease_seconds=0.4, state_path=path)
    e._last_beat = time.time() - 10
    assert e.receive_vote_request("m1:9333", 7, 0)["granted"]
    with open(path) as f:
        assert json.load(f) == {"term": 7, "voted_for": "m1:9333"}
    e2 = PACKAGES[reader]("m0:9333", PEERS, lease_seconds=0.4, state_path=path)
    e2._last_beat = time.time() - 10
    assert e2.term == 7 and e2.voted_for == "m1:9333"
    assert not e2.receive_vote_request("m2:9333", 7, 0)["granted"]
    assert e2.receive_vote_request("m1:9333", 7, 0)["granted"]
    # a higher term is adopted and written in the same format
    assert e2.receive_vote_request("m2:9333", 8, 0)["granted"]
    e3 = PACKAGES[writer]("m0:9333", PEERS, lease_seconds=0.4, state_path=path)
    assert (e3.term, e3.voted_for) == (8, "m2:9333")


def test_prevote_does_not_inflate_terms():
    """A flapping node's pre-vote is denied without a state change, so on
    heal the leader keeps leading in the same term."""
    net = SimNet()
    urls, nodes = make_cluster(net)
    try:
        assert wait_for(lambda: len(leaders(nodes)) == 1)
        lead = leaders(nodes)[0]
        term_before = lead.term
        flapper = next(e for e in nodes if e is not lead)
        net.partition({flapper.self_url}, {u for u in urls if u != flapper.self_url})
        time.sleep(flapper.lease_seconds * 6)
        net.heal()
        time.sleep(lead.lease_seconds * 2)
        assert lead.is_leader and lead.term == term_before
        assert flapper.leader == lead.self_url
    finally:
        stop_all(nodes)


def test_partition_fuzz(tmp_path):
    """The seeded partition fuzz of the JAX package's election fuzz test on a
    mixed five-node set: at most one leader holding a quorum-sized group,
    terms monotone per node across restarts (the durable state), and no
    quorum-acknowledged needle-id batch handed out twice."""
    rng = random.Random(0xEC)
    lease = 0.25
    net = SimNet()
    urls = [f"m{i}:9333" for i in range(5)]
    hw = {u: 0 for u in urls}  # each node's sequencer high-water mark

    def node(u):
        cls = (PElection, JElection)[urls.index(u) % 2]
        return make_node(net, u, urls, lease, cls,
                         get_max_file_key=lambda u=u: hw[u],
                         on_checkpoint=lambda k, u=u: hw.__setitem__(u, max(hw[u], k)),
                         state_path=str(tmp_path / (u.replace(":", "_") + ".json")))

    nodes = {u: node(u) for u in urls}
    for e in nodes.values():
        e.start()
    quorum = len(urls) // 2 + 1
    last_term = {u: 0 for u in urls}
    committed: set[int] = set()
    events = 0
    violations: list[str] = []

    def group_of(url):
        if net.groups is None:
            return set(urls)
        return next((set(g) for g in net.groups if url in g), {url})

    def check_invariants(settled):
        serving = []
        for u, e in nodes.items():
            if e.term < last_term[u]:
                violations.append(f"term regressed on {u}: {last_term[u]}->{e.term}")
            last_term[u] = max(last_term[u], e.term)
            if e.is_leader:
                serving.append(u)
        if settled:
            with_quorum = [u for u in serving if len(group_of(u)) >= quorum]
            if len(with_quorum) > 1:
                violations.append(f"split brain: {with_quorum}")

    def try_allocate():
        nonlocal events
        for u, e in nodes.items():
            if not e.is_leader:
                continue
            start = hw[u] + 1
            hw[u] += 10
            try:
                acks = e._send_beats()
            except Exception:  # noqa: BLE001 — a partitioned beat round counts no acks
                acks = 0
            if acks >= quorum:
                batch = set(range(start, start + 10))
                if batch & committed:
                    violations.append(f"needle-id reuse by {u}")
                committed.update(batch)
            events += 1

    partitions = [(urls[:2], urls[2:]), (urls[:3], urls[3:]), (urls[:1], urls[1:]),
                  (urls[:4], urls[4:]), ([urls[0], urls[2], urls[4]], [urls[1], urls[3]])]
    for round_no in range(60):
        op = rng.random()
        if op < 0.35:
            net.partition(*rng.choice(partitions))
        elif op < 0.55:
            net.heal()
        elif op < 0.70:
            u = rng.choice(urls)  # crash-restart: the durable term/vote survives
            nodes[u].stop()
            time.sleep(rng.uniform(0.02, 0.1))
            nodes[u] = node(u)
            nodes[u].start()
        events += 1
        time.sleep(rng.uniform(0.02, 0.1))
        try_allocate()
        check_invariants(settled=False)
        if round_no % 5 == 4:
            time.sleep(lease * 2.5)  # deposed leaders notice
            try_allocate()
            check_invariants(settled=True)
        if violations:
            break
    net.heal()
    try:
        assert not violations, violations[:5]
        assert wait_for(lambda: sum(e.is_leader for e in nodes.values()) == 1, timeout=15)
        assert events >= 100
    finally:
        stop_all(list(nodes.values()))
