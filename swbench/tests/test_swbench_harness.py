"""The harness on the CPU: each cell end to end at a small size, a new
configuration, traffic mix and per-layer metric found by name as files
alone, and ``correct`` false under the control and under each fault the
timed path of a cell can have."""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import run_small

CELLS = ["ec-seal-rebuild", "lineitem-q6-select"]


def _tree_sums(root: str) -> dict:
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def _host_metrics(root: str, cell: str) -> set:
    """The end-to-end metrics a CPU run reports: those on the host's clock
    (one from the device trace needs the card)."""
    from swbench import harness

    return {m["name"] for m in harness.Spec(root).metrics_of("end_to_end", cell)
            if m["source"] == "host_clock"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(small_root, cell):
    line = run_small(small_root, cell)
    assert line["correct"], line
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == _host_metrics(small_root, cell) >= {"setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values()), line
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"


def test_a_slower_scan_reads_fewer_MBps(small_root):
    """The query cell's closed loop reads what the port completes, not what
    was offered: a scan that takes longer reads fewer MB/s."""
    from seaweedfs_tpu_torch.server import volume_server

    real = volume_server.execute_request

    def slow(ctx, cluster):
        def execute_request(data, req, backend=None):
            time.sleep(0.3)
            return real(data, req, backend=backend)

        volume_server.execute_request = execute_request

    try:
        fast = run_small(small_root, "lineitem-q6-select")
        slowed = run_small(small_root, "lineitem-q6-select", inject=slow)
    finally:
        volume_server.execute_request = real
    assert fast["correct"] and slowed["correct"], (fast, slowed)
    rate = [x["metrics"]["read_MBps"]["value"] for x in (fast, slowed)]
    assert rate[1] < rate[0] / 2, rate


def test_new_files_are_found_by_name(small_root):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries, with no existing file edited."""
    before = _tree_sums(small_root)
    bench = os.path.join(small_root, "swbench")
    with open(os.path.join(bench, "configs", "warm-ec-rs10-4.json")) as f:
        cfg = json.load(f)
    cfg.update(name="warm-ec-rs10-4-b", volume_size_limit_bytes=2 << 20)
    with open(os.path.join(bench, "configs", "warm-ec-rs10-4-b.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "seal-three-slots.json"), "w") as f:
        json.dump({"kind": "seal_cycles", "volume_bytes": 2 << 20, "slots": 3,
                   "lost_shards": [1, 2, 11, 12]}, f)
    with open(os.path.join(bench, "layers", "cycles.rate.seal.py"), "w") as f:
        f.write("def read(run):\n    n = run['work'].get('generates')\n"
                "    return n / run['window_s'] if n else None\n")
    path = os.path.join(small_root, "BENCHMARK.json")
    with open(path) as f:
        doc = json.load(f)
    doc["configs"].append({"name": "warm-ec-rs10-4-b", "source": "x",
                           "file": "swbench/configs/warm-ec-rs10-4-b.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "seal-b", "config": "warm-ec-rs10-4-b",
                             "traffic": "seal-three-slots", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "cycles.rate.seal", "unit": "1/s", "better": "higher",
                             "source": "program_counter", "layer": "x",
                             "moves": "seal_rebuild_device_GBps", "workloads": ["seal-b"]})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if m["name"] in ("seal_rebuild_device_GBps", "seal_rebuild_wall_GBps"):
            m["workloads"].append("seal-b")
    with open(path, "w") as f:
        json.dump(doc, f)
    line = run_small(small_root, "seal-b", trace=True)
    assert line["correct"], line
    # the device's readers find nothing on the CPU; the host's rate is read
    assert set(line["metrics"]) == {"cycles.rate.seal", "seal_rebuild_wall_GBps"}
    assert line["metrics"]["cycles.rate.seal"]["value"] == pytest.approx(3 / 2.0, rel=0.5)
    assert line["metrics"]["seal_rebuild_wall_GBps"]["value"] > 0
    plain = run_small(small_root, "seal-b")
    assert set(plain["metrics"]) == {"setup_s"}  # seal_rebuild_device_GBps needs the card
    after = _tree_sums(small_root)
    assert {k: v for k, v in after.items() if k in before} == {
        k: v for k, v in before.items() if k != "BENCHMARK.json"} | {
        "BENCHMARK.json": after["BENCHMARK.json"]}


# -- the control and the faults ------------------------------------------------
def _codec_fault(kind: str):
    """Break every codec's product: ``unchanged`` leaves the output as it
    was given (zeros), ``half`` computes the first half of the columns only,
    ``altered`` flips one byte of it."""

    def inject(ctx, cluster):
        for vs in cluster.servers.values():
            codec = vs.store.ec_codec
            real = codec.matmul_device

            def matmul_device(matrix, data, out=None, accumulate=False, real=real):
                if kind == "unchanged":
                    return torch.zeros((len(matrix), data.shape[1]), dtype=torch.uint8) \
                        if out is None else out
                if kind == "half":
                    got = torch.zeros((len(matrix), data.shape[1]), dtype=torch.uint8)
                    h = data.shape[1] // 2
                    got[:, :h] = real(matrix, data[:, :h])
                else:
                    got = real(matrix, data).clone()
                    got[0, got.shape[1] // 3] ^= 1
                if out is None:
                    return got
                out.copy_(got)
                return out

            codec.matmul_device = matmul_device

    return inject


def _query_fault(kind: str):
    """Break the scan: ``unchanged`` answers every query with the first
    answer it gave, ``half`` scans the first half of the object only,
    ``altered`` changes one row's discount."""

    def inject(ctx, cluster):
        from seaweedfs_tpu_torch.server import volume_server

        real, first = volume_server.execute_request, []

        def execute_request(data, req, backend=None):
            if kind == "half":
                cut = data[:len(data) // 2]
                return real(cut[:cut.rfind(b"\n") + 1], req, backend=backend)
            status, out = real(data, req, backend=backend)
            if kind == "unchanged":
                first.append((status, out))
                return first[0]
            out["rows"][len(out["rows"]) // 2]["l_discount"] = "0.99"
            return status, out

        volume_server.execute_request = execute_request
        ctx.restore = lambda: setattr(volume_server, "execute_request", real)

    return inject


FAULTS = [("ec-seal-rebuild", k) for k in ("unchanged", "half", "altered")] + [
    ("lineitem-q6-select", k) for k in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_a_fault_is_not_correct(small_root, cell, kind):
    inject = (_query_fault if cell == "lineitem-q6-select" else _codec_fault)(kind)
    holder = {}

    def wrapped(ctx, cluster):
        inject(ctx, cluster)
        holder["ctx"] = ctx

    try:
        line = run_small(small_root, cell, inject=wrapped)
    finally:
        restore = getattr(holder.get("ctx"), "restore", None)
        if restore:
            restore()
    assert not line["correct"], line
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(small_root, cell):
    from seaweedfs_tpu_torch.server import volume_server

    real = volume_server.execute_request
    try:
        line = run_small(small_root, cell, control=True)
    finally:
        volume_server.execute_request = real
    assert not line["correct"], line


def test_rebuild_that_writes_nothing_is_not_correct(small_root, monkeypatch):
    """The seal cell's rebuild returning with its shards still deleted."""
    from seaweedfs_tpu_torch.ec import encoder

    monkeypatch.setattr(encoder, "rebuild_ec_files", lambda base, codec: [])
    line = run_small(small_root, "ec-seal-rebuild")
    assert not line["correct"] and line["checks"]["shard_files_wrong"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(tmp_path, cell):
    """The control at the cell's own size on the card (run there with
    ``python -m pytest swbench/tests -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import subprocess
    import sys

    from conftest import ROOT, SEED

    out = subprocess.run([sys.executable, "swbench/run.py", "--workload", cell, "--seed",
                          str(SEED + int(np.random.default_rng().integers(1 << 20))),
                          "--seconds", "20", "--trace", "0", "--control", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
