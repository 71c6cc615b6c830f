"""The port's operator utilities against the JAX package's.

- ``util/glog.py``: the 7 cases of the reference's ``tests/test_glog.py``
  replayed with the port's module, and the lines of every severity, of a
  ``V(n)`` gate and of ``exception``, on stderr and in a ``-logdir`` file,
  byte-equal to the JAX package's at a frozen clock.
- ``util/netports.py``: the 8 cases of ``tests/test_netports.py``.
- ``util/profiling.py``: ``tests/test_config_ui.py::
  test_profiling_writes_stats``, and ``-cpuprofile`` on the port's CLI.
- ``stats/histogram.py``: ``tests/test_trace.py::
  test_histogram_exemplar_carries_ambient_trace_id`` with the port's
  ``Histogram`` and span, and the exposition (exemplars included) equal to
  the JAX package's on the same observations.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pstats
import subprocess
import sys
import time

import pytest

import seaweedfs_tpu.util
from seaweedfs_tpu.stats.histogram import Histogram as JHistogram
from seaweedfs_tpu.util import glog as jglog
from seaweedfs_tpu_torch.stats import trace as ptrace
from seaweedfs_tpu_torch.stats.histogram import Histogram as PHistogram
from seaweedfs_tpu_torch.util import glog as pglog
from seaweedfs_tpu_torch.util import netports as pnetports
from seaweedfs_tpu_torch.util import profiling as pprofiling

import gateway_pair

REPO = gateway_pair.REPO
REF_GLOG = gateway_pair.ref_module("test_glog")
REF_NETPORTS = gateway_pair.ref_module("test_netports")
REF_CONFIG_UI = gateway_pair.ref_module("test_config_ui")
REF_TRACE = gateway_pair.ref_module("test_trace")


def _reset(g) -> None:
    g.set_verbosity(0)
    g.set_vmodule("")
    g.set_output(to_stderr=True, log_dir="", stderr_threshold="ERROR")


@pytest.fixture
def reset_both():
    yield
    for g in (jglog, pglog):
        _reset(g)
        with g._state.lock:
            if g._state._file is not None:
                g._state._file.close()
                g._state._file = None


@pytest.mark.parametrize("case", gateway_pair.cases(REF_GLOG))
def test_reference_glog_case(case, capsys, tmp_path, reset_both):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF_GLOG, "glog", pglog)
        fn = getattr(REF_GLOG, case)
        fixtures = {"capsys": capsys, "tmp_path": tmp_path}
        params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
        fn(**{n: fixtures[n] for n in params})


def _all_severities(g) -> None:
    """Every kind of line, each from the one line of this file per kind, so
    that both packages' lines name the same caller and line number."""
    g.info("hello %s %d", "world", 7)
    g.warning("careful: %r", {"k": 1})
    g.error("plain, no args %s")
    g.V(1).info("gated %d", 1)
    g.V(5).info("never")
    try:
        raise RuntimeError("boom %s")
    except RuntimeError:
        g.exception("op %s failed", "x")


def test_line_format_is_the_references(capsys, monkeypatch, tmp_path, reset_both):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.456789)
    out = {}
    for name, g in (("jax", jglog), ("port", pglog)):
        g.set_verbosity(2)
        _all_severities(g)
        out[name] = capsys.readouterr().err
    assert out["port"] == out["jax"]
    assert out["port"].count("\n") >= 5 and "never" not in out["port"]
    assert " test_torch_util_ops:" in out["port"]
    # the same lines in a -logdir file, ERROR and up copied to stderr
    files = {}
    for name, g in (("jax", jglog), ("port", pglog)):
        d = tmp_path / name
        g.set_output(to_stderr=False, log_dir=str(d), stderr_threshold="ERROR")
        _all_severities(g)
        g.flush()
        out[name] = capsys.readouterr().err
        files[name] = [p.read_text() for p in d.iterdir()]
    assert out["port"] == out["jax"] and "hello world" not in out["port"]
    assert "plain, no args" in out["port"]
    assert len(files["port"]) == len(files["jax"]) == 1
    assert files["port"] == files["jax"]


def test_vmodule_globs_and_flags_are_the_references(tmp_path, reset_both):
    argv = ["-v", "1", "-vmodule", "test_torch_*=3,other=0", "-logdir", str(tmp_path),
            "-stderrthreshold", "WARNING"]
    states = {}
    for name, g in (("jax", jglog), ("port", pglog)):
        p = argparse.ArgumentParser()
        g.add_flags(p)
        g.init_from_flags(p.parse_args(argv))
        st = g._state
        states[name] = (st.verbosity, st.vmodule, st.to_stderr, st.stderr_threshold,
                        st.log_dir, bool(g.V(3)), bool(g.V(4)))
        for bad in ("nolevel", "m=-2", "m=x"):
            with pytest.raises(ValueError):
                g.set_vmodule(bad)
    assert states["port"] == states["jax"]
    assert states["port"][5] and not states["port"][6]


def test_fatal_flushes_and_exits_255(tmp_path):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from seaweedfs_tpu_torch.util import glog\n"
            "glog.fatal('the end %%d', 3)\nprint('not reached')\n" % REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 255
    assert r.stderr.startswith("F") and "the end 3" in r.stderr
    assert "not reached" not in r.stdout


@pytest.mark.parametrize("case", gateway_pair.cases(REF_NETPORTS))
def test_reference_netports_case(case, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF_NETPORTS, "netports", pnetports)
        fn = getattr(REF_NETPORTS, case)
        params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
        fn(**{n: {"tmp_path": tmp_path}[n] for n in params})


def test_reference_profiling_writes_stats(tmp_path):
    """The reference case imports ``seaweedfs_tpu.util.profiling`` in its
    body: the JAX package's attribute is swapped for the port's module."""
    importlib.import_module("seaweedfs_tpu.util.profiling")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(seaweedfs_tpu.util, "profiling", pprofiling)
        REF_CONFIG_UI.test_profiling_writes_stats(tmp_path)
    assert pprofiling._cpu_profiler is None  # dumped, and off again


def test_cli_cpuprofile_and_memprofile_dump_at_exit(tmp_path):
    cpu, mem = tmp_path / "cpu.prof", tmp_path / "mem.txt"
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", f"-cpuprofile={cpu}",
         f"-memprofile={mem}", "version"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "cpu profiling on" in r.stderr and "cpu profile written" in r.stderr
    stats = pstats.Stats(str(cpu))
    assert any(fn[2] == "cmd_version" for fn in stats.stats)
    assert mem.read_text().count("\n") > 0


def test_reference_histogram_exemplar():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF_TRACE, "Histogram", PHistogram)
        mp.setattr(REF_TRACE, "start_span", ptrace.start_span)
        REF_TRACE.test_histogram_exemplar_carries_ambient_trace_id()


def test_histogram_exposition_with_exemplars_equal():
    out = {}
    for name, cls in (("jax", JHistogram), ("port", PHistogram)):
        h = cls("t_seconds", "latency", buckets=(0.001, 0.01, 0.1))
        for i, v in enumerate((0.0004, 0.003, 0.05, 0.07, 2.5)):
            h.observe(v, trace_id=f"{i:016x}", op="get")
        h.observe(0.002, trace_id='q"\\x', op="put")
        h.observe(0.02, trace_id="", op="put")  # no exemplar for an empty id
        h.observe(0.5, op="none")  # no ambient span: no exemplar
        out[name] = h.expose()
    assert out["port"] == out["jax"]
    text = "\n".join(out["port"])
    assert '# {trace_id="0000000000000004"} 2.5' in text
    assert 'op="none"' in text and text.count("# {trace_id=") == 5
