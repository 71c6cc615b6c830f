"""The shell's filer commands — ``fs.*``, ``bucket.*``, ``volume.fsck``,
``query``, ``trace`` and ``remote.dlq`` — of the port against the JAX
package's.

- The filer cases of the reference's ``tests/test_shell_ops.py``, replayed
  on a port master, volume server and filer (``ec_backend="cpu"``,
  ``query_backend="cpu"``) with the port's shell (``C``, ``CommandEnv``,
  ``run_command``) in place of the JAX package's; and replayed crosswise:
  the JAX shell over a port stack, the port shell over a JAX stack.
- One script of command lines run by each package's shell on its own
  stack, after the same writes: equal JSON once each stack's volume server
  address, the fids' cookies, and times are normalised.
- ``query`` rows equal to the JAX package's, on a plain CSV needle and on
  the same needle sealed with four shards lost (read through the kernel's
  plain version).
- ``trace`` over a port stack: a filer write's spans, from the filer and the
  volume server, in one tree.
- ``remote.dlq`` on the dead-letter queue a port ``ReplicationController``
  parks a poison event in: both shells list it alike, and the port's
  ``-replay`` applies it.
"""

from __future__ import annotations

import json
import re
import time

import pytest

from seaweedfs_tpu.shell import commands as jcommands
from seaweedfs_tpu.shell.commands import CommandEnv as JCommandEnv
from seaweedfs_tpu.shell.shell import run_command as j_run_command
from seaweedfs_tpu_torch.filer.client import FilerClient, FilerHTTPError
from seaweedfs_tpu_torch.replication import ReplicationController
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_bytes_headers, http_json
from seaweedfs_tpu_torch.shell import commands as pcommands
from seaweedfs_tpu_torch.shell.commands import CommandEnv as PCommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command as p_run_command

import gateway_pair
from gateway_pair import PORT_FILER, Stack, _jax_classes, free_port

REF = gateway_pair.ref_module("test_shell_ops")
FILER_CASES = ["test_fs_commands", "test_bucket_commands", "test_fsck_finds_planted_orphan",
               "test_fs_cat_mv_pwd_meta_cat", "test_fs_configure_rules", "test_fs_meta_notify"]
SHELL = {"jax": (jcommands, JCommandEnv, j_run_command),
         "port": (pcommands, PCommandEnv, p_run_command)}


def _filer_class(kind):
    return PORT_FILER if kind == "port" else _jax_classes()[2]


@pytest.fixture
def stacks(tmp_path):
    made: dict = {}

    def make(kind):
        made[kind] = Stack(kind, tmp_path / kind)
        return made[kind]

    yield make
    for s in made.values():
        s.stop()


def _replay(case, shell_kind, stack, tmp_path, monkeypatch):
    """Run the reference case on ``stack`` with ``shell_kind``'s shell."""
    C, env_cls, run = SHELL[shell_kind]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF, "C", C)
        mp.setattr(REF, "CommandEnv", env_cls)
        mp.setattr(REF, "run_command", run)
        mp.setattr(REF, "FilerServer", _filer_class(stack.kind))
        env = env_cls(stack.master.url, filer=stack.url)
        fixtures = {"filer_cluster": (stack.master, stack.volume, stack.filer, env),
                    "tmp_path": tmp_path, "monkeypatch": monkeypatch}
        fn = getattr(REF, case)
        params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
        fn(**{n: fixtures[n] for n in params})


@pytest.mark.parametrize("case", FILER_CASES)
def test_reference_case(case, stacks, tmp_path, monkeypatch):
    _replay(case, "port", stacks("port"), tmp_path, monkeypatch)


@pytest.mark.parametrize("case", ["test_fs_commands", "test_bucket_commands",
                                  "test_fs_cat_mv_pwd_meta_cat", "test_fs_configure_rules",
                                  "test_fsck_finds_planted_orphan"])
@pytest.mark.parametrize("shell,stack", [("jax", "port"), ("port", "jax")])
def test_reference_case_crosswise(case, shell, stack, stacks, tmp_path, monkeypatch):
    _replay(case, shell, stacks(stack), tmp_path, monkeypatch)


# -- the same command lines on both packages -----------------------------------
FILES = {"/docs/a.txt": b"alpha " * 40, "/docs/sub/b.txt": b"bravo",
         "/docs/sub/deeper/c.bin": bytes(range(256)) * 9, "/top.txt": b"t"}
SCRIPT = [
    "fs.pwd", "fs.ls /", "fs.ls /docs", "fs.cd /docs", "fs.pwd", "fs.ls", "fs.ls a.txt",
    "fs.du /", "fs.du", "fs.tree /", "fs.cat a.txt", "fs.cat sub/b.txt", "fs.meta.cat a.txt",
    "fs.mv sub/b.txt /docs/moved.txt", "fs.cat /docs/moved.txt", "fs.tree",
    "fs.cd ..", "fs.cd ./docs/../docs/sub", "fs.pwd", "fs.cd /",
    "bucket.list", "bucket.create -name=photos", "bucket.create -name=logs", "bucket.list",
    "bucket.delete -name=photos", "bucket.list",
    "fs.configure", "fs.configure -locationPrefix=/cold/ -collection=cold -ttl=3d",
    "fs.configure -locationPrefix=/cold/ -collection=cold -replication=000 -apply=true",
    "fs.configure", "fs.configure -locationPrefix=/cold/ -delete=true -apply=true",
    "volume.fsck", "help", "bogus.cmd",
]
_FID = re.compile(r'"(\d+),([0-9a-f]+?)([0-9a-f]{8})"')
# times; a chunk's volume id; and its etag, the CRC of the stored bytes,
# which for a gzip'd chunk hold gzip's time stamp
_TIMES = {"mtime", "crtime", "ts_ns", "mtime_ns", "last_modified", "append_ns", "vid", "etag"}


def _normalised(result, volume_url: str):
    """Times, etags, the fids' volume ids (placement picks among the
    writable volumes at random) and cookies out; the stack's volume server
    named."""
    def walk(x):
        if isinstance(x, dict):
            return {k: ("T" if k in _TIMES else walk(v)) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    text = json.dumps(walk(result), sort_keys=True, default=str)
    text = text.replace(volume_url, "VOLUME")
    return _FID.sub(lambda m: f'"V,{m.group(2)}"', text)


def _run_script(stack, kind) -> list:
    for path, data in FILES.items():
        assert http_bytes("POST", f"http://{stack.url}{path}", data)[0] == 201
    _, env_cls, run = SHELL[kind]
    env = env_cls(stack.master.url, filer=stack.url)
    vurl = f"{stack.volume.host}:{stack.volume.port}"
    out = []
    for line in SCRIPT:
        try:
            out.append(_normalised(run(env, line), vurl))
        except Exception as e:  # noqa: BLE001 — an error is a result to compare too
            out.append(f"error {type(e).__name__}: {str(e).replace(vurl, 'VOLUME')}")
    return out


def test_same_command_lines_give_equal_json(stacks):
    got = {kind: _run_script(stacks(kind), kind) for kind in ("jax", "port")}
    for line, j, p in zip(SCRIPT, got["jax"], got["port"]):
        assert p == j, line
    assert got["port"][SCRIPT.index("fs.cat a.txt")] == json.dumps("alpha " * 40)
    assert json.loads(got["port"][SCRIPT.index("volume.fsck")])["orphans"] == []


# -- query, plain and sealed ------------------------------------------------------
CSV = ("id,region,score,name\n" + "".join(
    f"{i},{'east' if i % 3 else 'west'},{(i * 37) % 1000},n{i}\n" for i in range(4000))).encode()
SQL = "SELECT * FROM s3object WHERE region = 'east' AND score > 900"


def _query_rows(kind, env) -> list:
    _, _, run = SHELL[kind]
    r = run(env, f'query -path=/q/data.csv "{SQL}"')
    return r["rows"] if "rows" in r else r


def test_query_rows_equal_plain_and_sealed(stacks):
    rows, made = {}, {}
    for kind in ("jax", "port"):
        s = made[kind] = stacks(kind)
        assert http_bytes("POST", f"http://{s.url}/q/data.csv", CSV)[0] == 201
        env = SHELL[kind][1](s.master.url, filer=s.url)
        rows[kind] = _query_rows(kind, env)
    assert rows["port"] == rows["jax"] and len(rows["port"]) > 50
    # seal the CSV's volume on the port stack, lose four shards, query again
    s = made["port"]
    env = PCommandEnv(s.master.url, filer=s.url)
    fid = http_json("GET", f"http://{s.url}/q/data.csv?meta=true")["chunks"][0]["file_id"]
    vid = int(fid.split(",")[0])
    p_run_command(env, f"ec.encode -volumeId={vid}")
    vurl = f"{s.volume.host}:{s.volume.port}"
    assert "error" not in http_json(
        "POST", f"http://{vurl}/admin/ec/delete_shards?volume={vid}&shards=1,5,9,13")
    assert http_json("GET", f"http://{vurl}/status")["volumes"] == [] or \
        vid not in [v["id"] for v in http_json("GET", f"http://{vurl}/status")["volumes"]]
    assert _query_rows("port", env) == rows["jax"]


# -- trace -----------------------------------------------------------------------
def test_trace_assembles_a_filer_write(stacks):
    s = stacks("port")
    status, _, headers = http_bytes_headers("POST", f"http://{s.url}/t/traced.txt", b"x" * 5000)
    assert status == 201
    tid = headers["X-Sweed-Trace-Id"]
    env = PCommandEnv(s.master.url, filer=s.url)
    r = p_run_command(env, f"trace {tid}")
    assert r == p_run_command(env, f"trace -id={tid}")
    assert r["trace_id"] == tid and r["daemons_queried"] == 3 and r["unreachable"] == []
    assert r["span_count"] >= 2
    assert "filer" in r["tree"] and "volume" in r["tree"]
    # the JAX shell's collector over the port's daemons assembles the same tree
    jr = j_run_command(JCommandEnv(s.master.url, filer=s.url), f"trace {tid}")
    assert jr == r
    with pytest.raises(ValueError):
        p_run_command(env, "trace")


# -- remote.dlq ------------------------------------------------------------------
def test_remote_dlq_list_and_replay(stacks, tmp_path):
    a = stacks("port")
    b = Stack("port", tmp_path / "b")
    try:
        dlq_dir = tmp_path / "dlq"
        dlq_dir.mkdir()
        ctrl = ReplicationController(a.url, b.url, dlq_dir=str(dlq_dir), source_path="/dlqt")
        sync = ctrl.a_to_b
        assert http_bytes("POST", f"http://{a.url}/dlqt/poison.bin", b"parked" * 30)[0] < 300
        real_create = sync.sink.create_entry

        def poisoned(path, *args, **kw):
            if path.endswith("poison.bin"):
                raise FilerHTTPError("PUT", path, 400, b"schema rejected")
            return real_create(path, *args, **kw)

        sync.sink.create_entry = poisoned
        assert sync.sync_once() >= 1 and ctrl.dlq_ab.depth() == 1
        sync.sink.create_entry = real_create
        env = PCommandEnv(a.master.url, filer=a.url)
        listing = p_run_command(env, f"remote.dlq -dir={dlq_dir}")
        assert listing == j_run_command(JCommandEnv(a.master.url, filer=a.url),
                                        f"remote.dlq -dir={dlq_dir}")
        assert list(listing) == ["a_to_b"]  # nothing parked the other way: no file
        assert listing["a_to_b"]["depth"] == 1
        entry = listing["a_to_b"]["entries"][0]
        assert entry["path"] == "/dlqt/poison.bin" and "400" in entry["error"]
        assert p_run_command(env, f"remote.dlq -dir={dlq_dir} -direction=b_to_a") == {}
        replayed = p_run_command(env, f"remote.dlq -dir={dlq_dir} -replay -direction=a_to_b")
        assert replayed == {"a_to_b": {"replayed": 1, "failed": 0}}
        assert ctrl.dlq_ab.depth() == 0
        assert FilerClient(b.url).get_object("/dlqt/poison.bin")[:2] == (200, b"parked" * 30)
        with pytest.raises(RuntimeError):
            p_run_command(env, "remote.dlq")
    finally:
        b.stop()


def test_fs_meta_save_load_across_packages(stacks, tmp_path):
    """A dump of the port's ``fs.meta.save`` loads into a JAX filer over the
    same volumes through the JAX shell, and the files read back."""
    s = stacks("port")
    for path, data in FILES.items():
        assert http_bytes("POST", f"http://{s.url}{path}", data)[0] == 201
    dump = tmp_path / "meta.jsonl"
    env = PCommandEnv(s.master.url, filer=s.url)
    assert p_run_command(env, f"fs.meta.save -o={dump} /docs")["saved"] == 3
    jfs = _jax_classes()[2](port=free_port(), master_url=s.master.url).start()
    s.extra.append(jfs)
    assert j_run_command(JCommandEnv(s.master.url, filer=jfs.url),
                         f"fs.meta.load -i={dump}") == {"loaded": 3}
    deadline = time.time() + 10
    for path, data in FILES.items():
        if path.startswith("/docs"):
            while time.time() < deadline and http_bytes("GET", f"http://{jfs.url}{path}")[0] != 200:
                time.sleep(0.1)
            assert http_bytes("GET", f"http://{jfs.url}{path}") == (200, data)
