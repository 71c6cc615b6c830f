"""A trio of the port's masters (``MasterServer(peers=...)``), after the JAX
package's ``tests/test_master_ha.py``: the trio elects one leader and a
follower proxies assigns and lookups to it; when the leader dies the next one
takes over without issuing a needle id or a volume id twice, and the volume
server follows it; a shell pinned to the dead leader carries on through a
surviving seed. A lone master is its own leader at once.
"""

import socket
import time

import pytest

from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.shell import CommandEnv, run_command_with_failover
from seaweedfs_tpu_torch.storage.file_id import FileId


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_for(cond, timeout=10.0, interval=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(interval)
    return None


@pytest.fixture()
def trio(tmp_path):
    ports = sorted(free_port() for _ in range(3))
    urls = [f"127.0.0.1:{p}" for p in ports]
    masters = [MasterServer(port=p, peers=urls, lease_seconds=1.2, node_timeout=60,
                            meta_dir=str(tmp_path / f"m{i}")).start()
               for i, p in enumerate(ports)]
    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=",".join(urls),
                      max_volume_count=10, pulse_seconds=0.3, ec_backend="cpu").start()
    yield urls, masters, vs
    vs.stop()
    for m in masters:
        m.stop()


def leader_of(url):
    try:
        return http_json("GET", f"http://{url}/cluster/status", timeout=2.0).get("leader")
    except OSError:
        return None


def agreed(urls):
    leads = {leader_of(u) for u in urls}
    return leads.pop() if len(leads) == 1 and None not in leads else None


def known_nodes(url):
    return http_json("GET", f"http://{url}/dir/status")["topology"]["data_centers"]


def key_of(fid):
    return FileId.parse(fid).key


def test_election_converges_and_proxies(trio):
    urls, masters, vs = trio
    lead = wait_for(lambda: agreed(urls))
    assert lead == urls[0]  # the lowest url campaigns first
    assert [m.election.is_leader for m in masters] == [True, False, False]
    assert wait_for(lambda: known_nodes(lead))
    # an assign sent to a follower is proxied to the leader
    a = http_json("POST", f"http://{urls[2]}/dir/assign")
    assert a.get("fid") and a["url"] == f"127.0.0.1:{vs.port}", a
    assert http_bytes("POST", f"http://{a['url']}/{a['fid']}", b"via follower")[0] == 201
    # a lookup through the other follower answers from the leader's topology
    vid = FileId.parse(a["fid"]).volume_id
    locs = http_json("GET", f"http://{urls[1]}/dir/lookup?volumeId={vid}")["locations"]
    assert http_bytes("GET", f"http://{locs[0]['url']}/{a['fid']}") == (200, b"via follower")
    # the followers' own status tells who leads, their term agrees
    st = [http_json("GET", f"http://{u}/dir/status") for u in urls]
    assert [s["is_leader"] for s in st] == [True, False, False]
    assert len({s["term"] for s in st}) == 1
    # the proxy marks its hop: a proxied request to a follower is refused
    r = http_json("GET", f"http://{urls[1]}/dir/assign?proxied=1")
    assert r.get("_status") == 503


def test_failover_keeps_sequence_and_volume_ids(trio):
    urls, masters, vs = trio
    assert wait_for(lambda: agreed(urls)) == urls[0]
    assert wait_for(lambda: known_nodes(urls[0]))
    a1 = http_json("POST", f"http://{urls[0]}/dir/assign")
    grown = http_json("POST", f"http://{urls[0]}/vol/grow?collection=ha&count=1")
    assert grown == {"count": 1}
    max_vid = masters[0].master.topo.max_volume_id
    # the beats carry both high-water marks to the followers
    assert wait_for(lambda: masters[1].master.sequencer.peek() > key_of(a1["fid"]))
    assert wait_for(lambda: masters[1].master.topo.max_volume_id >= max_vid)
    masters[0].stop()
    new_lead = wait_for(lambda: agreed(urls[1:]) not in (None, urls[0]) and agreed(urls[1:]),
                        timeout=15)
    assert new_lead == urls[1]
    assert wait_for(lambda: vs.master_url == new_lead, timeout=15)
    assert wait_for(lambda: known_nodes(new_lead), timeout=15)
    a2 = http_json("POST", f"http://{new_lead}/dir/assign")
    assert key_of(a2["fid"]) > key_of(a1["fid"])
    assert http_json("POST", f"http://{new_lead}/vol/grow?collection=ha2&count=1") == {
        "count": 1}
    assert masters[1].master.topo.max_volume_id > max_vid
    assert http_bytes("POST", f"http://{a2['url']}/{a2['fid']}", b"after failover")[0] == 201
    assert http_bytes("GET", f"http://{a2['url']}/{a2['fid']}") == (200, b"after failover")


def test_single_master_is_its_own_leader():
    m = MasterServer(port=free_port(), node_timeout=60).start()
    try:
        assert leader_of(m.url) == m.url
        st = http_json("GET", f"http://{m.url}/cluster/status")
        assert st["is_leader"] is True and st["term"] == 1
    finally:
        m.stop()


def test_shell_survives_midsession_leader_death(trio):
    """A shell pinned to the leader carries on after it dies: the failover
    wrapper re-resolves to a surviving seed and retries a read-only command;
    the autopilot's status, proxied to the new leader, answers too."""
    urls, masters, vs = trio
    leader = wait_for(lambda: agreed(urls))
    assert leader
    env = CommandEnv(",".join([leader] + [u for u in urls if u != leader]))
    assert run_command_with_failover(env, "cluster.status")
    masters[urls.index(leader)].stop()
    out = None
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            out = run_command_with_failover(env, "cluster.status")
            break
        except Exception:  # noqa: BLE001 — the cluster is still electing
            time.sleep(0.5)
    assert out, "the shell never recovered after the leader's death"
    assert env.master != leader

    def status():
        try:  # 502 naming the dead leader until the followers elect
            return run_command_with_failover(env, "lifecycle.status")
        except RuntimeError:
            return None

    st = wait_for(status, timeout=15)
    assert st and st["enabled"] is False and "cycle" in st
