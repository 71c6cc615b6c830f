"""BENCHMARK.json keeps to the benchmark's contract, and every name it
gives has its file."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head")


def _doc() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    doc = _doc()
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(doc["paths"]) <= 16 and len(doc["command"]) <= 32
    assert all(_line(w) for w in doc["command"])
    assert isinstance(doc["run_seconds"], int) and 1 <= doc["run_seconds"] <= 51
    assert (2 + 14 * 24) * (doc["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries():
    doc = _doc()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in doc[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(doc["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
    cells = {w["name"] for w in doc["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in doc["workloads"]}
    assert len(pairs) == len(cells)
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert os.path.exists(os.path.join(ROOT, "swbench", "traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "swbench", "layers", m["name"] + ".py"))
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in doc["end_to_end"]:  # a metric from the device trace has a reader of its own
        if m["source"] == "device_trace":
            assert os.path.exists(os.path.join(ROOT, "swbench", "end_to_end", m["name"] + ".py"))
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one
        assert sum(cell in m.get("workloads", cells) for m in doc["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in doc["per_layer"])
