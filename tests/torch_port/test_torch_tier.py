"""The S3-class cold tier of the port (``storage/backend/``,
``Volume.tier_upload``/``tier_download``, ``/admin/tier_*``, the shell's
``volume.tier.*``), held against the JAX package's.

The tier cases of the JAX package's ``tests/test_backup_tier.py`` run on a
cluster of either package (a master and a volume server) against the
in-repo ``fake_s3``: upload, ranged reads from the tier, download; a named
backend keeps the secrets out of the ``.tier`` descriptor; a tiered volume
survives a restart; a failed upload rolls the seal back. Then the state that
crosses packages: a volume tiered by one package loads and reads byte-equal
in the other, both ways, and the two S3 clients sign the same requests the
same on a frozen clock.
"""

import datetime as dt
import json
import os
import socket
import threading
import time

import pytest

import seaweedfs_tpu.s3api.s3_client as j_s3
import seaweedfs_tpu.storage.backend_config as j_backend_config
import seaweedfs_tpu_torch.s3api.s3_client as p_s3
import seaweedfs_tpu_torch.storage.backend_config as p_backend_config
from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.volume import Volume as JVolume
from seaweedfs_tpu.util.config import Configuration as JConfiguration
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command
from seaweedfs_tpu_torch.storage.backend.fake_s3 import FakeS3Server
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu_torch.storage.volume import Volume as PVolume
from seaweedfs_tpu_torch.util.config import Configuration as PConfiguration

PACKAGES = {
    "jax": (JMasterServer, JVolumeServer, j_backend_config, JConfiguration),
    "port": (MasterServer, VolumeServer, p_backend_config, PConfiguration),
}


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


class Cluster:
    def __init__(self, pkg, tmp_path):
        self.pkg = pkg
        Master, Volume = PACKAGES[pkg][:2]
        self.master = Master(port=free_port(), node_timeout=60).start()
        self.dirs = [str(tmp_path / "v")]
        self.volume = self._volume_server()
        assert _wait(lambda: http_json("GET", f"http://{self.master.url}/dir/status")
                     ["topology"]["data_centers"])

    def _volume_server(self):
        Volume = PACKAGES[self.pkg][1]
        return Volume(self.dirs, port=free_port(), master_url=self.master.url,
                      max_volume_count=10, pulse_seconds=0.3).start()

    @property
    def vol_url(self):
        return f"{self.volume.host}:{self.volume.port}"

    def submit(self, data: bytes) -> str:
        a = http_json("POST", f"http://{self.master.url}/dir/assign")
        status, _ = http_bytes("POST", f"http://{a['url']}/{a['fid']}", data)
        assert status == 201
        return a["fid"]

    def get(self, fid: str):
        return http_bytes("GET", f"http://{self.vol_url}/{fid}")

    def restart_volume_server(self):
        self.volume.stop()
        self.volume = self._volume_server()

    def stop(self):
        self.volume.stop()
        # the JAX master's stop waits out its election loop: let it go aside
        threading.Thread(target=self.master.stop, daemon=True).start()


@pytest.fixture(params=list(PACKAGES))
def cluster(request, tmp_path):
    c = Cluster(request.param, tmp_path)
    yield c
    c.stop()


@pytest.fixture
def s3(tmp_path):
    with FakeS3Server(str(tmp_path / "s3")) as srv:
        yield srv


def test_tier_upload_read_download(cluster, s3):
    fids = [cluster.submit(f"tiered {i}".encode() * 100) for i in range(10)]
    vid = int(fids[0].split(",")[0])
    r = http_json("POST", f"http://{cluster.vol_url}/admin/tier_upload?volume={vid}"
                          f"&endpoint={s3.endpoint}&bucket=tier")
    assert r.get("key") == f"default_{vid}.dat", r
    assert "secret_key" not in r
    base = cluster.volume.store.find_volume(vid).file_name()
    assert not os.path.exists(base + ".dat") and os.path.exists(base + ".tier")
    with open(base + ".tier") as f:
        assert json.load(f)["size"] == os.path.getsize(s3.object_path("tier", r["key"]))
    # reads go through ranged GETs against the tier
    for i, fid in enumerate(fids):
        assert cluster.get(fid) == (200, f"tiered {i}".encode() * 100)
    r = http_json("POST", f"http://{cluster.vol_url}/admin/tier_download?volume={vid}")
    assert r.get("ok"), r
    assert os.path.exists(base + ".dat") and not os.path.exists(base + ".tier")
    assert cluster.get(fids[3]) == (200, b"tiered 3" * 100)


def test_tier_named_backend_keeps_secrets_out(cluster, s3, monkeypatch):
    """``backend=s3.lab``: the descriptor carries the backend's name only;
    the credentials resolve through backend.toml when the volume opens and
    when it downloads."""
    _, _, backend_config, Configuration = PACKAGES[cluster.pkg]
    fid = cluster.submit(b"named backend payload " * 200)
    vid = int(fid.split(",")[0])
    conf = Configuration({"s3": {"lab": {"endpoint": s3.endpoint, "access_key": "AK",
                                         "secret_key": "SK"}}}, "backend")
    monkeypatch.setattr(backend_config, "load_configuration", lambda name: conf)
    r = http_json("POST", f"http://{cluster.vol_url}/admin/tier_upload?volume={vid}"
                          f"&bucket=tier2&backend=s3.lab")
    assert r.get("key"), r
    v = cluster.volume.store.find_volume(vid)
    with open(v.tier_file()) as f:
        info = json.load(f)
    assert info["backend"] == "s3.lab"
    for forbidden in ("access_key", "secret_key", "endpoint"):
        assert forbidden not in info, info
    assert cluster.get(fid) == (200, b"named backend payload " * 200)
    r = http_json("POST", f"http://{cluster.vol_url}/admin/tier_download?volume={vid}")
    assert r.get("ok"), r
    assert os.path.exists(v.file_name() + ".dat")
    with pytest.raises(KeyError):
        backend_config.resolve_backend("s3.nope", conf)


def test_tiered_volume_survives_reload(cluster, s3):
    """A restarted volume server opens a tiered volume from its .tier."""
    fid = cluster.submit(b"persistent tier data")
    vid = int(fid.split(",")[0])
    r = http_json("POST", f"http://{cluster.vol_url}/admin/tier_upload?volume={vid}"
                          f"&endpoint={s3.endpoint}&bucket=tier2")
    assert r.get("key"), r
    cluster.restart_volume_server()
    assert cluster.volume.store.find_volume(vid).is_tiered()
    assert cluster.get(fid) == (200, b"persistent tier data")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_tier_upload_failure_rolls_back_writability(tmp_path, pkg):
    """A failed upload must not leave the volume read-only."""
    Volume, Needle = {"jax": (JVolume, JNeedle), "port": (PVolume, PNeedle)}[pkg]
    v = Volume(str(tmp_path), "", 9)
    v.write_needle(Needle(id=1, cookie=1, data=b"x"))
    with pytest.raises(Exception):
        v.tier_upload(f"http://127.0.0.1:{free_port()}", "nope")  # nothing listens
    assert v.read_only is False
    v.write_needle(Needle(id=2, cookie=2, data=b"still writable"))
    assert not os.path.exists(v.tier_file())
    v.close()


# -- state that crosses the packages ------------------------------------------

def _fill(Volume, Needle, d, n=40):
    v = Volume(d, "col", 5)
    blobs = {}
    for i in range(1, n + 1):
        data = os.urandom(37 * i)
        v.write_needle(Needle(id=i, cookie=0x1234, data=data))
        blobs[i] = data
    v.sync()
    return v, blobs


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_tiered_volume_reads_equal_across_packages(tmp_path, s3, writer, reader):
    """One package tiers a volume; the other loads it from the .tier
    descriptor and reads every needle byte-equal through ranged GETs, then
    brings the .dat back with the same bytes the writer uploaded."""
    vols = {"jax": (JVolume, JNeedle), "port": (PVolume, PNeedle)}
    d = str(tmp_path / "d")
    os.makedirs(d)
    v, blobs = _fill(*vols[writer], d)
    with open(v.file_name() + ".dat", "rb") as f:
        dat = f.read()
    info = v.tier_upload(s3.endpoint, "cross", access_key="AK", secret_key="SK")
    assert info == {"bucket": "cross", "key": "col_5.dat", "size": len(dat),
                    "endpoint": s3.endpoint}
    v.close()
    Volume, Needle = vols[reader]
    w = Volume(d, "col", 5, create_if_missing=False)
    assert w.read_only and w.is_tiered()
    for nid, data in blobs.items():
        n = Needle(id=nid, cookie=0x1234)
        w.read_needle(n)
        assert bytes(n.data) == data
    w.tier_download()
    assert not w.is_tiered() and not os.path.exists(w.tier_file())
    with open(w.file_name() + ".dat", "rb") as f:
        assert f.read() == dat
    w.close()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_deleted_tiered_volume_stays_deleted(tmp_path, s3, pkg):
    """Deleting a tiered volume removes its descriptor in the port, so it
    does not load again. The JAX package's destroy leaves the .tier behind
    and the volume comes back at the next start."""
    Volume, Needle = {"jax": (JVolume, JNeedle), "port": (PVolume, PNeedle)}[pkg]
    d = str(tmp_path)
    v, _ = _fill(Volume, Needle, d, n=3)
    v.tier_upload(s3.endpoint, "gone")
    v.destroy()
    assert os.path.exists(os.path.join(d, "col_5.tier")) == (pkg == "jax")


class _FrozenDatetime(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 17, 12, 34, 56, tzinfo=tz)


@pytest.mark.parametrize("method,path,query,headers,body", [
    ("PUT", "/bucket/col_5.dat", {}, {}, b"payload " * 64),
    ("GET", "/bucket/col_5.dat", {}, {"Range": "bytes=100-4095"}, b""),
    ("POST", "/bucket/big.dat", {"uploads": ""}, {}, b""),
    ("PUT", "/bucket/big.dat", {"partNumber": "2", "uploadId": "abc123"}, {}, b"\x00\xff" * 99),
    ("GET", "/bucket", {"list-type": "2", "prefix": "a b/c~"}, {"X-Amz-Meta-K": "  v  w "}, b""),
    ("PUT", "/bucket/s.dat", {}, {"X-Amz-Content-Sha256": "STREAMING-AWS4-HMAC-SHA256-PAYLOAD",
                                  "X-Amz-Decoded-Content-Length": "10"}, b""),
])
def test_sigv4_signatures_equal(monkeypatch, method, path, query, headers, body):
    monkeypatch.setattr(j_s3, "datetime", _FrozenDatetime)
    monkeypatch.setattr(p_s3, "datetime", _FrozenDatetime)
    args = ("http://127.0.0.1:8333", "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY")
    jc, pc = j_s3.S3Client(*args, region="eu-west-1"), p_s3.S3Client(*args, region="eu-west-1")
    want = jc._sign(method, path, query, headers, body)
    assert pc._sign(method, path, query, headers, body) == want
    assert "Signature=" in want["Authorization"]
    # without credentials neither signs
    anon = (p_s3.S3Client("http://h:1")._sign(method, path, query, headers, body),
            j_s3.S3Client("http://h:1")._sign(method, path, query, headers, body))
    assert anon == (headers, headers)


def test_shell_tier_commands_on_a_port_cluster(tmp_path, s3):
    """``volume.tier.upload`` and ``volume.tier.download`` from the port's
    shell, on a port cluster with two replicas: one uploads, the other
    verifies the object and writes its own descriptor."""
    master = MasterServer(port=free_port(), node_timeout=60).start()
    servers = [VolumeServer([str(tmp_path / f"v{i}")], port=free_port(), master_url=master.url,
                            pulse_seconds=0.3, ec_backend="cpu").start() for i in range(2)]
    try:
        assert _wait(lambda: len(master.master.topo.data_nodes()) == 2)
        assert http_json("POST", f"http://{master.url}/vol/grow?collection=t&replication=001"
                                 "&count=1") == {"count": 1}
        a = http_json("POST", f"http://{master.url}/dir/assign?collection=t&replication=001")
        assert http_bytes("POST", f"http://{a['url']}/{a['fid']}", b"two replicas")[0] == 201
        vid = int(a["fid"].split(",")[0])
        env = CommandEnv(master.url)
        up = run_command(env, f"volume.tier.upload -volumeId={vid} -endpoint={s3.endpoint} "
                              "-bucket=shell")
        assert len(up["tiered"]) == 2 and os.listdir(os.path.join(s3.root, "shell")) == [
            f"t_{vid}.dat"]
        for vs in servers:
            v = vs.store.find_volume(vid)
            assert v.is_tiered() and v.turbo is None
            assert http_bytes("GET", f"http://127.0.0.1:{vs.port}/{a['fid']}") == (
                200, b"two replicas")
        down = run_command(env, f"volume.tier.download -volumeId={vid}")
        assert len(down["downloaded"]) == 2
        for vs in servers:  # local again: the engine serves it (read-only)
            v = vs.store.find_volume(vid)
            assert not v.is_tiered() and v.read_only and v.turbo is vs.store.turbo_engine
            assert http_bytes("GET", f"http://127.0.0.1:{vs.port}/{a['fid']}") == (
                200, b"two replicas")
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_scrub_leaves_a_tiered_volume_alone(tmp_path, s3, monkeypatch, pkg):
    """The scrub re-reads a volume's needles every round. A tiered volume's
    .dat is the backend's: the port's scrub skips it, where the JAX
    package's GETs the whole object through the tier round after round."""
    monkeypatch.setenv("SWEED_SCRUB", "1")
    monkeypatch.setenv("SWEED_SCRUB_RATE", "10000")
    c = Cluster(pkg, tmp_path)
    try:
        fid = c.submit(b"scrubbed? " * 300)
        vid = int(fid.split(",")[0])
        r = http_json("POST", f"http://{c.vol_url}/admin/tier_upload?volume={vid}"
                              f"&endpoint={s3.endpoint}&bucket=scrub")
        assert r.get("key"), r
        time.sleep(2.5)  # two scrub rounds
        gets = len(s3.ranged_gets)
        assert (gets == 0) == (pkg == "port"), gets
        assert c.get(fid) == (200, b"scrubbed? " * 300)
    finally:
        c.stop()
