"""The port's replication (``replication/``) held against the JAX package's.

- The factories: ``make_queue`` over ``notification.toml`` and ``make_sink``
  over ``replication.toml`` pick the same queue and sink, with the same
  settings, as the JAX package's on the same files.
- Signing: at a fixed clock, ``SqsQueue``'s SigV4 headers and ``AzureSink``'s
  SharedKey requests are byte for byte the JAX package's.
- The bus: a queue that hangs does not stall the filer's mutations, the
  prefix filters, a file queue holds one event per mutation.
- ``filer.sync`` between two port clusters (a port master, volume server
  and filer each): active-passive with the offset checkpoint, active-active
  with loop prevention, last-writer-wins under conflicting writes, a poison
  event parked in the dead-letter queue and replayed, and ``/_status``'s
  ``sync`` section.
- Across the packages: a port ``FilerSync`` from a JAX filer into a port
  filer writes the JAX package's marker and offset keys, and a JAX
  ``FilerSync`` resumes from the port's offset.
- The reference's fast crash matrix (``tests/test_replication_chaos.py``): a
  child process running two port clusters is killed at ``repl.sink.write``,
  ``repl.apply.marker`` and ``repl.offset.checkpoint``; the clusters come
  back from disk and the trees converge with the redelivery proven a no-op.
"""

import base64
import datetime as _dt
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import tomllib
import urllib.request

import pytest

from seaweedfs_tpu.replication import cloud_sinks as jcloud
from seaweedfs_tpu.replication import filer_sync as jfiler_sync
from seaweedfs_tpu.replication import notification as jnotification
from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu.util.config import Configuration as JConfiguration
from seaweedfs_tpu_torch.filer.client import FilerClient, FilerHTTPError
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.replication import (
    DeadLetterQueue,
    FilerSync,
    LocalFsSink,
    MemoryQueue,
    NotificationBus,
    ReplicationController,
    Replicator,
    cloud_sinks,
    notification,
    sync_stats,
)
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.util import faultpoints
from seaweedfs_tpu_torch.util.config import Configuration

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def confs(text: str):
    data = tomllib.loads(text)
    return Configuration(data, "test"), JConfiguration(data, "test")


# -- factories -------------------------------------------------------------------
QUEUES = [
    ("", None),
    ("[notification]\nenabled = false\n[notification.log]\nenabled = true\n", None),
    ("[notification.log]\nenabled = true\n", "LogQueue"),
    ('[notification.file]\nenabled = true\npath = "{tmp}/ev.jsonl"\n', "FileQueue"),
    ('[notification.webhook]\nenabled = true\nurl = "http://x/ev"\n', "WebhookQueue"),
    ('[notification.aws_sqs]\nenabled = true\naws_access_key_id = "a"\n'
     'aws_secret_access_key = "s"\nsqs_queue_url = "https://sqs.eu-west-1.amazonaws.com/1/q"\n'
     'region = "eu-west-1"\n', "SqsQueue"),
]


@pytest.mark.parametrize("text,kind", QUEUES, ids=[k or f"none{i}" for i, (_, k) in
                                                     enumerate(QUEUES)])
def test_make_queue_factory_selection(tmp_path, text, kind):
    pconf, jconf = confs(text.format(tmp=tmp_path))
    p, j = notification.make_queue(pconf), jnotification.make_queue(jconf)
    assert type(p).__name__ == type(j).__name__ == (kind or "NoneType")
    if p is not None:
        assert vars(p).keys() == vars(j).keys()
        for k in vars(p):
            if k not in ("_lock",):
                assert getattr(p, k) == getattr(j, k), k
    if kind == "FileQueue":
        p.send("/a", {"op": "c"})
        assert j.read_all() == p.read_all() == [{"key": "/a", "message": {"op": "c"}}]


def test_gated_queues_and_log_queue(monkeypatch):
    notification.LogQueue().send("/k", {"op": "x"})
    for text, sdk in (("[notification.kafka]\nenabled = true\n", "kafka-python"),
                      ("[notification.google_pub_sub]\nenabled = true\n",
                       "google-cloud-pubsub")):
        with pytest.raises(ImportError, match=sdk):
            notification.make_queue(confs(text)[0])
    import types

    calls = {}

    class _FakeProducer:
        def __init__(self, bootstrap_servers=None):
            calls["hosts"] = bootstrap_servers

    fake = types.ModuleType("kafka")
    fake.KafkaProducer = _FakeProducer
    monkeypatch.setitem(sys.modules, "kafka", fake)
    monkeypatch.setenv("WEED_NOTIFICATION_KAFKA_HOSTS", "k1:9092, k2:9092")
    q = notification.make_queue(confs("[notification.kafka]\nenabled = true\n")[0])
    assert calls["hosts"] == ["k1:9092", "k2:9092"] and q.topic == "seaweedfs"


SINKS = [
    ('[sink.local]\nenabled = true\ndirectory = "{tmp}/mirror"\n', "LocalFsSink",
     ("root",)),
    ('[sink.filer]\nenabled = true\ngrpcAddress = "h:1"\ndirectory = "/m"\n', "FilerSink",
     ("prefix", "signatures")),
    ('[sink.s3]\nenabled = true\nendpoint = "http://h:9"\nbucket = "b"\n'
     'aws_access_key_id = "a"\naws_secret_access_key = "s"\ndirectory = "p"\n', "S3Sink",
     ("bucket", "key_prefix")),
    ('[sink.gcs]\nenabled = true\nbucket = "b"\naccess_key = "a"\nsecret_key = "s"\n',
     "GcsSink", ("bucket", "key_prefix")),
    ('[sink.backblaze]\nenabled = true\nbucket = "b"\nregion = "eu-central-003"\n', "B2Sink",
     ("bucket", "key_prefix")),
    ('[sink.azure]\nenabled = true\naccount_name = "a"\naccount_key = "'
     + base64.b64encode(b"k").decode() + '"\ncontainer = "c"\n', "AzureSink",
     ("account", "key", "container", "key_prefix", "endpoint")),
]


@pytest.mark.parametrize("text,kind,attrs", SINKS, ids=[s[1] for s in SINKS])
def test_make_sink_factory_selection(tmp_path, text, kind, attrs):
    pconf, jconf = confs(text.format(tmp=tmp_path))
    p, j = cloud_sinks.make_sink(pconf), jcloud.make_sink(jconf)
    assert type(p).__name__ == type(j).__name__ == kind
    for a in attrs:
        assert getattr(p, a) == getattr(j, a), a
    if hasattr(p, "client") and hasattr(p.client, "endpoint"):
        assert p.client.endpoint == j.client.endpoint


def test_make_sink_none_enabled():
    with pytest.raises(ValueError, match="no sink enabled"):
        cloud_sinks.make_sink(confs("")[0])


# -- signing at a fixed clock -------------------------------------------------------
class _FixedClock(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return _dt.datetime(2026, 3, 4, 5, 6, 7, tzinfo=_dt.timezone.utc)


def test_sqs_sigv4_headers_equal_jax(monkeypatch):
    monkeypatch.setattr(notification, "datetime", _FixedClock)
    monkeypatch.setattr(jnotification, "datetime", _FixedClock)
    args = ("https://sqs.us-east-1.amazonaws.com/1234/events", "AKID", "secret/key")
    p, j = notification.SqsQueue(*args), jnotification.SqsQueue(*args)
    body = b"Action=SendMessage&MessageBody=%7B%7D"
    got = p._signed_headers("sqs.us-east-1.amazonaws.com", body)
    assert got == j._signed_headers("sqs.us-east-1.amazonaws.com", body)
    assert got["X-Amz-Date"] == "20260304T050607Z"
    assert got["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKID/20260304/us-east-1/sqs/aws4_request, "
        "SignedHeaders=content-type;host;x-amz-date, Signature=")


def test_sqs_send_carries_the_signed_request(monkeypatch):
    monkeypatch.setattr(notification, "datetime", _FixedClock)
    monkeypatch.setattr(jnotification, "datetime", _FixedClock)
    sent = []

    class _Resp:
        status = 200

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(req, timeout=None):
        sent.append((req.full_url, req.get_method(), dict(req.header_items()), req.data))
        return _Resp()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    for mod in (notification, jnotification):
        mod.SqsQueue("https://sqs.us-east-1.amazonaws.com/1234/events", "AK", "SK",
                     endpoint="http://127.0.0.1:9").send("/p", {"ts_ns": 1})
    assert sent[0] == sent[1]
    assert sent[0][0] == "http://127.0.0.1:9/" and sent[0][1] == "POST"


def test_azure_sharedkey_requests_equal_jax(monkeypatch):
    monkeypatch.setattr(cloud_sinks, "datetime", _FixedClock)
    monkeypatch.setattr(jcloud, "datetime", _FixedClock)
    sent = []

    class _Resp:
        status = 201

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(req, timeout=None):
        sent.append((req.full_url, req.get_method(), dict(req.header_items()), req.data))
        return _Resp()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    key = base64.b64encode(b"super-secret-azure-key").decode()
    for mod in (cloud_sinks, jcloud):
        sink = mod.AzureSink("acct", key, "cont", key_prefix="pre", endpoint="http://az:1")
        sink.create_entry("/dir/a b.txt", {"is_directory": False}, b"payload")
        sink.create_entry("/empty", {"is_directory": False}, b"")
        sink.create_entry("/d", {"is_directory": True}, None)

        def deleted(req, timeout=None):
            sent.append((req.full_url, req.get_method(), dict(req.header_items()), req.data))

            class _R(_Resp):
                status = 202
            return _R()

        monkeypatch.setattr(urllib.request, "urlopen", deleted)
        sink.delete_entry("/dir/a b.txt", False)
        monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    half = len(sent) // 2
    assert half == 3 and sent[:half] == sent[half:]
    url, verb, headers, data = sent[0]
    assert url == "http://az:1/cont/pre/dir/a%20b.txt" and verb == "PUT" and data == b"payload"
    assert headers["Authorization"].startswith("SharedKey acct:")
    assert headers["X-ms-date"] == "Wed, 04 Mar 2026 05:06:07 GMT"


# -- the bus and the replicator ------------------------------------------------------
def test_replicator_event_mapping(tmp_path):
    sink = LocalFsSink(str(tmp_path / "mirror"))
    store = {"/x/f1": b"one", "/x/f2": b"two"}
    r = Replicator(sink, read_content=store.get, source_path="/x")
    r.replicate({"old_entry": None, "new_entry": {"full_path": "/x/f1", "chunks": [1]}})
    assert (tmp_path / "mirror/f1").read_bytes() == b"one"
    store["/x/f1renamed"] = b"one"
    r.replicate({"old_entry": {"full_path": "/x/f1"},
                 "new_entry": {"full_path": "/x/f1renamed", "chunks": [1]}})
    assert not (tmp_path / "mirror/f1").exists()
    assert (tmp_path / "mirror/f1renamed").read_bytes() == b"one"
    r.replicate({"old_entry": {"full_path": "/x/f1renamed"}, "new_entry": None})
    assert not (tmp_path / "mirror/f1renamed").exists()
    assert not r.replicate({"old_entry": None,
                            "new_entry": {"full_path": "/other/f", "chunks": [1]}})
    r2 = Replicator(sink, read_content=store.get, exclude_signature=42)
    assert not r2.replicate({"old_entry": None, "signatures": [42],
                             "new_entry": {"full_path": "/x/f2", "chunks": [1]}})
    assert (r.replicated, r.skipped, r2.skipped) == (3, 1, 1)


def test_notification_bus_prefix_and_file_queue(tmp_path):
    filer = Filer()
    q = MemoryQueue()
    fq = notification.FileQueue(str(tmp_path / "events.jsonl"))
    bus = NotificationBus(filer, prefix="/watched").add_queue(q).add_queue(fq)
    filer.create_entry(Entry(full_path="/watched/a.txt"))
    filer.create_entry(Entry(full_path="/elsewhere/b.txt"))
    filer.delete_entry("/watched/a.txt")
    keys = [q.receive(timeout=2)[0] for _ in range(3)]
    assert keys == ["/watched", "/watched/a.txt", "/watched/a.txt"]
    assert q.receive(timeout=0.2) is None
    bus.detach()
    recs = fq.read_all()
    assert [r["key"] for r in recs] == keys
    assert recs[-1]["message"]["new_entry"] is None
    assert jnotification.FileQueue(fq.path).read_all() == recs


def test_bus_does_not_block_filer_mutations():
    gate = threading.Event()
    delivered = []

    class _Stuck(notification.MessageQueue):
        def send(self, key, message):
            gate.wait(timeout=10)
            delivered.append(key)

    f = Filer()
    bus = NotificationBus(f).add_queue(_Stuck())
    t0 = time.monotonic()
    for i in range(20):
        f.create_entry(Entry(full_path=f"/nb/f{i}.txt"))
    assert time.monotonic() - t0 < 1.0
    gate.set()
    deadline = time.time() + 5
    while len(delivered) < 21 and time.time() < deadline:
        time.sleep(0.05)
    assert delivered == ["/nb"] + [f"/nb/f{i}.txt" for i in range(20)]
    bus.detach()


# -- filer.sync between two port clusters --------------------------------------------
def _cluster(tmp, name, jax_filer=False):
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volume = VolumeServer([str(tmp / name)], port=free_port(), master_url=master.url,
                          max_volume_count=20, pulse_seconds=0.5, ec_backend="cpu").start()
    filer = FilerServer(port=free_port(), master_url=master.url, chunk_size=64 * 1024,
                        query_backend="cpu").start()
    out = [master, volume, filer]
    if jax_filer:
        out.append(JFilerServer(port=free_port(), master_url=master.url,
                                chunk_size=64 * 1024).start())
    deadline = time.time() + 10
    while time.time() < deadline and not master.master.topo.data_nodes():
        time.sleep(0.05)
    return out


@pytest.fixture(scope="module")
def two_clusters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repl")
    a = _cluster(tmp, "a", jax_filer=True)
    b = _cluster(tmp, "b")
    yield a[2], b[2], a[3]
    threading.Thread(target=a[3].stop, daemon=True).start()
    for cluster in (a, b):
        cluster[2].stop()
        cluster[1].stop()
        cluster[0].stop()


def tree_of(filer_url, root):
    """path -> sha1(content) for every file under root, via the filer API."""
    c = FilerClient(filer_url)
    out, stack = {}, [root]
    while stack:
        d = stack.pop()
        for e in c.list(d):
            p = e["full_path"]
            if e.get("is_directory"):
                stack.append(p)
            else:
                status, data, _ = c.get_object(p)
                assert status == 200, f"{filer_url}{p} -> {status}"
                out[p] = hashlib.sha1(data).hexdigest()
    return out


def test_active_passive_sync(two_clusters):
    fa, fb, _ = two_clusters
    http_bytes("POST", f"http://{fa.url}/sync/doc.txt", b"replicate me")
    sync = FilerSync(fa.url, fb.url, source_path="/sync")
    assert sync.sync_once() >= 1
    assert http_bytes("GET", f"http://{fb.url}/doc.txt") == (200, b"replicate me")
    http_bytes("DELETE", f"http://{fa.url}/sync/doc.txt")
    sync.sync_once()
    assert http_bytes("GET", f"http://{fb.url}/doc.txt")[0] == 404
    # offset checkpoint: a fresh syncer resumes, not replays
    assert FilerSync(fa.url, fb.url, source_path="/sync").sync_once() == 0
    st = sync.stats()
    assert st["replicated"] >= 2 and st["parked"] == 0 and st["offset_ns"] > 0


def test_active_active_sync(two_clusters):
    fa, fb, _ = two_clusters
    ab = FilerSync(fa.url, fb.url, source_path="/aa", target_path="/aa").start()
    ba = FilerSync(fb.url, fa.url, source_path="/aa", target_path="/aa").start()
    try:
        http_bytes("POST", f"http://{fa.url}/aa/from_a.txt", b"written on A")
        http_bytes("POST", f"http://{fb.url}/aa/from_b.txt", b"written on B")
        deadline = time.time() + 10
        while time.time() < deadline:
            s1, d1 = http_bytes("GET", f"http://{fb.url}/aa/from_a.txt")
            s2, d2 = http_bytes("GET", f"http://{fa.url}/aa/from_b.txt")
            if s1 == 200 and s2 == 200:
                break
            time.sleep(0.1)
        assert d1 == b"written on A" and d2 == b"written on B"
        time.sleep(0.8)  # any ping-pong (there must be none) settles
        assert ab.replicator.skipped >= 1 or ba.replicator.skipped >= 1
        assert http_bytes("GET", f"http://{fb.url}/aa/from_a.txt") == (200, b"written on A")
    finally:
        ab.stop()
        ba.stop()


def test_lww_conflicting_writes_converge(two_clusters, tmp_path):
    fa, fb, _ = two_clusters
    ctrl = ReplicationController(fa.url, fb.url, dlq_dir=str(tmp_path),
                                 source_path="/lww").start()
    try:
        candidates = {}
        for i in range(6):
            p = f"/lww/doc_{i}.txt"
            va, vb = f"A wrote {i}".encode(), f"B wrote {i}".encode()
            candidates[p] = {hashlib.sha1(va).hexdigest(), hashlib.sha1(vb).hexdigest()}
            http_bytes("POST", f"http://{fa.url}{p}", va)
            http_bytes("POST", f"http://{fb.url}{p}", vb)
        deadline, stable_since = time.time() + 30, None
        while True:
            ta, tb = tree_of(fa.url, "/lww"), tree_of(fb.url, "/lww")
            if ta == tb and len(ta) == 6:
                if stable_since is None:
                    stable_since = time.time()
                elif time.time() - stable_since > 1.0:
                    break
            else:
                stable_since = None
            assert time.time() < deadline, f"no convergence: {ta} vs {tb}"
            time.sleep(0.2)
        assert all(h in candidates[p] for p, h in ta.items())
        s = ctrl.stats()
        assert s["a_to_b"]["parked"] == 0 and s["b_to_a"]["parked"] == 0
        assert s["a_to_b"]["lww_skipped"] + s["b_to_a"]["lww_skipped"] >= 1, s
        # /_status reads the same snapshot, network-free
        for url in (fa.url, fb.url):
            sync = json.loads(http_bytes("GET", f"http://{url}/_status")[1])["sync"]
            d = sync["directions"]["a_to_b"]
            for k in ("replicated", "redelivered", "lww_skipped", "retries", "parked",
                      "stalls", "inflight", "lag_s", "offset_ns", "dlq_depth"):
                assert k in d, d
        assert sync_stats()["totals"]["dlq_depth"] == 0
    finally:
        ctrl.stop()


def test_dlq_park_and_replay(two_clusters, tmp_path):
    fa, fb, _ = two_clusters
    dlq = DeadLetterQueue(str(tmp_path / "dlq.a_to_b.jsonl"))
    sync = FilerSync(fa.url, fb.url, source_path="/dlqt", target_path="/dlqt",
                     direction="a_to_b", dlq=dlq)
    assert http_bytes("POST", f"http://{fa.url}/dlqt/poison.bin", b"parked payload" * 20)[0] \
        < 300
    real_create = sync.sink.create_entry

    def poisoned(path, *a, **k):
        if path.endswith("poison.bin"):
            raise FilerHTTPError("PUT", path, 400, b"schema rejected")
        return real_create(path, *a, **k)

    sync.sink.create_entry = poisoned
    assert sync.sync_once() >= 1
    assert sync.parked == 1 and dlq.depth() == 1
    assert sync.sync_once() == 0  # the offset moved past the parked event
    entry = dlq.entries()[0]
    assert entry["path"] == "/dlqt/poison.bin" and "400" in entry["error"]
    assert dlq.replay() == {"replayed": 1, "failed": 0}
    assert dlq.depth() == 0
    assert FilerClient(fb.url).get_object("/dlqt/poison.bin")[:2] == \
        (200, b"parked payload" * 20)


def test_port_sync_from_a_jax_filer_shares_its_keys(two_clusters):
    """A port FilerSync out of a JAX filer into a port filer: the marker and
    offset keys are the JAX package's, and a JAX FilerSync on the same pair
    resumes from the port's checkpoint."""
    _, fb, jfa = two_clusters
    for i in range(3):
        assert http_bytes("POST", f"http://{jfa.url}/xj/f{i}.txt", f"from jax {i}".encode())[0] \
            < 300
    p = FilerSync(jfa.url, fb.url, source_path="/xj", target_path="/xj")
    j = jfiler_sync.FilerSync(jfa.url, fb.url, source_path="/xj", target_path="/xj")
    assert (p.src_sig, p.tgt_sig, p._offset_key) == (j.src_sig, j.tgt_sig, j._offset_key)
    events = FilerClient(jfa.url).meta_events(since_ns=0)["events"]
    for ev in events:
        path = FilerSync._event_path(ev)
        if path:
            assert p._marker_key(ev, path) == j._marker_key(ev, path)
    assert p.sync_once() >= 4
    for i in range(3):
        assert http_bytes("GET", f"http://{fb.url}/xj/f{i}.txt") == (200, f"from jax {i}".encode())
    assert FilerClient(fb.url).kv_get(p._offset_key) == str(p._offset_cache).encode()
    assert j.sync_once() == 0  # resumes from the port's durable offset
    http_bytes("POST", f"http://{jfa.url}/xj/late.txt", b"late")
    assert j.sync_once() >= 1 and p.sync_once() == 0
    assert http_bytes("GET", f"http://{fb.url}/xj/late.txt") == (200, b"late")


def test_s3_sink_into_the_port_gateway(two_clusters):
    from seaweedfs_tpu_torch.replication import S3Sink
    from seaweedfs_tpu_torch.s3api import S3ApiServer
    from seaweedfs_tpu_torch.s3api.s3_client import S3Client

    _, fb, _ = two_clusters
    api = S3ApiServer(port=free_port(), filer_url=fb.url).start()
    try:
        c = S3Client(f"http://{api.url}")
        c.create_bucket("mirror")
        for sink in (S3Sink(f"http://{api.url}", "mirror"),
                     cloud_sinks.GcsSink("mirror", key_prefix="gcs",
                                         endpoint=f"http://{api.url}")):
            prefix = getattr(sink, "key_prefix", "")
            key = f"{prefix}/obj.bin" if prefix else "obj.bin"
            r = Replicator(sink, read_content={"/data/obj.bin": b"to s3"}.get,
                           source_path="/data")
            r.replicate({"old_entry": None,
                         "new_entry": {"full_path": "/data/obj.bin", "chunks": [1]}})
            assert c.get_object("mirror", key)[:2] == (200, b"to s3")
            r.replicate({"old_entry": {"full_path": "/data/obj.bin"}, "new_entry": None})
            assert c.get_object("mirror", key)[0] == 404
    finally:
        api.stop()


# -- the fast crash matrix --------------------------------------------------------------
# Two persistent port clusters in one process, their ports kept in the state
# dir so that a restart brings back the same urls (the offset key names the
# source filer's url). The child runs the storm and dies at the armed fault;
# this process restarts the clusters from disk and drains.
CLUSTERS = r"""
import json, os, socket, time
from seaweedfs_tpu_torch.replication import FilerSync
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def boot(statedir):
    path = os.path.join(statedir, "ports.json")
    if os.path.exists(path):
        with open(path) as f:
            ports = json.load(f)
    else:
        ports = {k: free_port() for k in ("ma", "va", "fa", "mb", "vb", "fb")}
        with open(path, "w") as f:
            json.dump(ports, f)
    out = []
    for name in ("a", "b"):
        vdir = os.path.join(statedir, "vol_" + name)
        os.makedirs(vdir, exist_ok=True)
        master = MasterServer(port=ports["m" + name], node_timeout=60,
                              meta_dir=os.path.join(statedir, "meta_" + name)).start()
        volume = VolumeServer([vdir], port=ports["v" + name], master_url=master.url,
                              max_volume_count=20, pulse_seconds=0.3,
                              ec_backend="cpu").start()
        filer = FilerServer(port=ports["f" + name], master_url=master.url,
                            chunk_size=64 * 1024, query_backend="cpu",
                            db_path=os.path.join(statedir, "filer_" + name + ".db")).start()
        deadline = time.time() + 20
        while True:
            try:
                if http_bytes("POST", "http://" + filer.url + "/probe/ready.txt", b"up")[0] < 300:
                    break
            except OSError:
                pass
            if time.time() > deadline:
                raise SystemExit("cluster " + name + " never became ready")
            time.sleep(0.1)
        out.append((master, volume, filer))
    return out


def blob(tag, i):
    return (tag + ":" + str(i) + "|").encode() * (37 + i * 13)


def drain(sync, budget=60):
    zeros, deadline = 0, time.time() + budget
    while zeros < 2:
        n = sync.sync_once()
        zeros = zeros + 1 if n == 0 else 0
        if time.time() > deadline:
            raise SystemExit("sync did not converge within budget")
        if n == 0:
            time.sleep(0.05)


def stop(clusters):
    for c in clusters:
        c[2].stop(); c[1].stop(); c[0].stop()
"""

STORM = CLUSTERS + r"""
import sys
from seaweedfs_tpu_torch.util import faultpoints

statedir = sys.argv[1]
faultspec = sys.argv[2] if len(sys.argv) > 2 else ""
ca, cb = boot(statedir)
fa, fb = ca[2], cb[2]
sync = FilerSync(fa.url, fb.url, source_path="/sync", target_path="/sync")
for i in range(8):
    http_bytes("POST", "http://%s/sync/seed_%03d.bin" % (fa.url, i), blob("seed", i))
drain(sync)
if faultspec:  # armed only now: skip/count land inside the storm
    faultpoints._parse_env(faultspec)
for i in range(24):
    http_bytes("POST", "http://%s/sync/storm_%03d.bin" % (fa.url, i), blob("storm", i))
drain(sync)  # an armed crash fault kills the process in here
print("CHILD-COMPLETED", flush=True)
os._exit(0)  # everything is durable: leave as abruptly as a crash would
"""

# tier-1 subset: one crash per distinct protocol window
FAST_MATRIX = [
    ("", 0),
    ("repl.sink.write=crash::3", 1),
    ("repl.apply.marker=crash::2", 1),
    ("repl.offset.checkpoint=crash", 1),
]


@pytest.mark.crash
@pytest.mark.parametrize("faultspec,min_redelivered", FAST_MATRIX,
                         ids=[f or "no-fault" for f, _ in FAST_MATRIX])
def test_crash_matrix_fast(tmp_path, faultspec, min_redelivered):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("SWEED_FAULTPOINTS", None)
    proc = subprocess.run([sys.executable, "-c", STORM, str(tmp_path), faultspec],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    if faultspec:
        assert proc.returncode == faultpoints.CRASH_EXIT_CODE, proc.stderr[-2000:]
        assert "CHILD-COMPLETED" not in proc.stdout
    else:
        assert proc.returncode == 0 and "CHILD-COMPLETED" in proc.stdout, proc.stderr[-2000:]
    ns: dict = {}
    exec(CLUSTERS, ns)  # noqa: S102 — the same boot code the child ran
    clusters = ns["boot"](str(tmp_path))
    try:
        fa, fb = clusters[0][2], clusters[1][2]
        sync = FilerSync(fa.url, fb.url, source_path="/sync", target_path="/sync")
        ns["drain"](sync)
        ta, tb = tree_of(fa.url, "/sync"), tree_of(fb.url, "/sync")
        assert ta == tb, set(ta.items()) ^ set(tb.items())
        assert len(ta) == 32, sorted(ta)
        st = sync.stats()
        assert st["parked"] == 0, st
        assert st["redelivered"] >= min_redelivered, st
        if not faultspec:
            assert st["redelivered"] == 0 and st["replicated"] == 0, st
    finally:
        ns["stop"](clusters)
