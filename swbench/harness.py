"""The harness: finds a cell's files by name, runs it once, prints its line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``swbench/configs/<config>.json`` (the ``file`` of the configuration);
- ``swbench/traffic/<traffic>.json``, whose ``kind`` names the driver
  ``swbench/drivers/<kind>.py``;
- ``swbench/layers/<metric>.py``, with ``read(run) -> float | None``, for a
  per-layer metric; ``swbench/end_to_end/<metric>.py``, the same, for an
  end-to-end metric whose ``source`` is ``device_trace``. A ``--trace 0``
  run of a cell that reports one runs the profiler over its window.

A driver has ``setup(ctx, cluster)``, ``window(ctx, state)`` and
``finish(ctx, state, observed) -> Outcome``. ``setup`` starts the program
through ``cluster`` (``swbench/cluster.py``) and fills it; ``window`` opens
the measured window with ``ctx.begin_window()`` and closes it with
``ctx.end_window()``. The harness then reads the device's memory peak and
stops the cluster, and ``finish`` runs the plain reference over what the
window produced.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")  # top-level module names
LEAD_S = 0.25  # from opening the window to its first request


def load_module(path: str, name: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)
        self.bench = os.path.join(root, self.doc["paths"][0])

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def driver(self, kind: str):
        return load_module(os.path.join(self.bench, "drivers", f"{kind}.py"),
                           f"swbench_driver_{kind}")

    def reader(self, kind: str, metric: str):
        """The reader of a metric: ``kind`` is ``layers`` or ``end_to_end``."""
        return load_module(os.path.join(self.bench, kind, f"{metric}.py"),
                           f"swbench_{kind}_{metric.replace('.', '_')}")

    def metrics_of(self, kind: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.doc[kind] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Outcome:
    """What a driver hands back once the reference has judged the window."""

    metrics: dict  # host-clock metric -> value, end-to-end or per-layer (setup_s is the harness's)
    attempted: int
    failed: int
    checks: dict  # name -> (number compared, its limit); correct iff every one <= limit
    counters: dict = dataclasses.field(default_factory=dict)  # program counters, for layers
    work: dict = dataclasses.field(default_factory=dict)  # work done, from shapes, for layers
    detail: dict = dataclasses.field(default_factory=dict)  # more of the run, for the reader


class Context:
    """One run of one cell, as drivers see it."""

    def __init__(self, spec: Spec, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", control: bool = False, inject=None):
        self.spec, self.seed, self.seconds, self.trace = spec, seed, seconds, trace
        # the profiler runs over the window for the per-layer metrics, or for
        # an end-to-end metric taken from the device trace
        self.profile = trace or any(m["source"] == "device_trace"
                                    for m in spec.metrics_of("end_to_end", cell))
        self.cell = spec.workload(cell)
        self.config = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.device, self.control, self.inject = device, control, inject
        # the run's files: git-ignored, at a fixed path, emptied each run
        self.work = os.path.join(spec.root, "swbench_work", cell)
        self.window = None  # (t0, t1) in time.monotonic
        self.window_end = None  # when the window's last work ended (>= t1)
        self._tracer = None
        self._wall_offset = 0

    def begin_window(self) -> tuple:
        """Start tracing if asked; returns the window (t0, t1)."""
        if self.profile and self.device == "cuda":
            from .trace import WindowTrace

            self._tracer = WindowTrace(sample=self.trace)
            self._tracer.start()
        t0 = time.monotonic() + LEAD_S
        self.window = (t0, t0 + self.seconds)
        self._wall_offset = time.time_ns() - int(time.monotonic() * 1e9)
        return self.window

    def end_window(self, at: float) -> None:
        """The window's work ended at ``at``: stop tracing."""
        self.window_end = max(at, self.window[1])
        if self._tracer is not None:
            self._tracer.stop()

    def device_summary(self):
        if self._tracer is None:
            return None
        from .trace import summary

        t0 = int(self.window[0] * 1e9) + self._wall_offset
        t1 = int(self.window_end * 1e9) + self._wall_offset
        return summary(self._tracer.events(), self._tracer.samples, t0, t1)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _memory_peak(device: str) -> int:
    if device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_reserved())


def _device_info(device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def run_cell(spec: Spec, cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             inject=None) -> dict:
    """Run one cell once; returns the result line's object."""
    import shutil

    ctx = Context(spec, cell, seed, seconds, trace, device, control, inject)
    shutil.rmtree(ctx.work, ignore_errors=True)
    os.makedirs(ctx.work)
    driver = spec.driver(ctx.traffic["kind"])
    from .cluster import Cluster

    cluster = Cluster(ctx)
    try:
        state = driver.setup(ctx, cluster)
        os.sync()  # what set-up wrote is on disk before the window opens
        observed = driver.window(ctx, state)
        peak = _memory_peak(device)
    finally:
        cluster.stop()
    outcome = driver.finish(ctx, state, observed)
    setup_s = ctx.window[0] - t_start
    dev = {**_device_info(device, ctx.cell["chips"]), "memory_peak_bytes": peak}
    line: dict = {"correct": all(v <= lim for v, lim in outcome.checks.values()),
                  "attempted": outcome.attempted, "failed": outcome.failed}
    metrics = {}
    summ = ctx.device_summary()
    run = {"device": summ, "host": outcome.metrics, "counters": outcome.counters,
           "work": outcome.work, "peaks": _peaks(dev["kind"]),
           "window_s": ctx.window_end - ctx.window[0]}
    if not trace:
        values = {**outcome.metrics, "setup_s": setup_s}
        for m in spec.metrics_of("end_to_end", cell):
            v = (spec.reader("end_to_end", m["name"]).read(run)
                 if m["source"] == "device_trace" else values[m["name"]])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.metrics_of("per_layer", cell):
            v = spec.reader("layers", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summ is not None:
            dev.update(busy_s=summ["busy_s"], window_s=summ["window_s"])
            line["breakdown"] = {"device_ops": summ["device_ops"],
                                 "idle_gaps": summ["idle_gaps"]}
    line.update(metrics=metrics, device=dev, detail=outcome.detail)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    shutil.rmtree(ctx.work, ignore_errors=True)
    return line


def _peaks(kind: str) -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    return table.get(kind, {})
