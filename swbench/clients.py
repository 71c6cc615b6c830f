"""The load generator: tasks that run in worker processes of their own.

Nothing here imports torch or the program: a worker speaks HTTP to the
servers in the benchmark's main process, so the clients never hold the
servers' interpreter lock. A worker is started by ``Worker`` (spawned, not
forked), runs one task, may report ``("ready", info)`` and then wait for
``("go", t0, t1, ...)`` (``time.monotonic`` instants, which all processes
of a host share), and ends with ``("result", value)``.

The query cell's load is a closed loop (``closed_loop``): a fixed number of
streams, each sending its next request as soon as its last has answered.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import multiprocessing
import threading
import time
import traceback

REQUEST_TIMEOUT = 120.0  # seconds a request may take before it counts as failed


def call(conn: http.client.HTTPConnection, method: str, path: str, body=None,
         headers=None) -> tuple:
    """(status, body) of one request on a kept-alive connection."""
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _connect(url: str) -> http.client.HTTPConnection:
    return http.client.HTTPConnection(url, timeout=REQUEST_TIMEOUT)


def _fresh(conn: http.client.HTTPConnection) -> http.client.HTTPConnection:
    conn.close()
    return _connect(f"{conn.host}:{conn.port}")


def _wait_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


# -- set-up tasks ---------------------------------------------------------------
def upload_direct(conn, url: str, vid: int, needles: dict) -> list:
    """POST the needles of ``gen.needles.Needles(**needles)`` in order over
    one connection, each under a fid made here: [status]."""
    from .gen.needles import Needles, fid

    ns = Needles(**needles)
    c, out = _connect(url), []
    try:
        for i in range(len(ns)):
            status, _ = call(c, "POST", "/" + fid(vid, ns.key(i), ns.cookie(i)), ns.payload(i))
            out.append(status)
    finally:
        c.close()
    return out


def upload_objects(conn, url: str, vid: int, seed: int, indices: list, size: int,
                   cookies: list) -> list:
    """Make the lineitem objects ``indices`` and POST each as one needle:
    [(index, status, bytes)]."""
    from .gen.lineitem import lineitem_csv
    from .gen.needles import fid

    c, out = _connect(url), []
    try:
        for i, cookie in zip(indices, cookies):
            data = lineitem_csv(seed, i, size)
            status, _ = call(c, "POST", "/" + fid(vid, i + 1, cookie), data)
            out.append((i, status, len(data)))
    finally:
        c.close()
    return out


def q6_reference(conn, seed: int, indices: list, size: int, params: dict,
                 narrow: bool) -> list:
    """The plain filter's answer for each lineitem object: [(index, rows,
    digest)] (``narrow``: the control's float32 reading)."""
    from .gen.lineitem import lineitem_csv
    from .reference import q6

    out = []
    for i in indices:
        sel = q6.rows(lineitem_csv(seed, i, size), params,
                      q6.narrow if narrow else float)
        out.append((i, len(sel), q6.digest(sel)))
    return out


# -- measured tasks -------------------------------------------------------------
def seal_cycles(conn, url: str, vid: int, base: str, lost: list, slots: int) -> dict:
    """One warm-up cycle, then after ``go`` one cycle in each of ``slots``
    slots evenly spread over [t0, t1): a slot starts at its time or when
    the previous cycle ends, whichever is later. A cycle is
    ``/admin/ec/generate``, ``/admin/ec/delete_shards`` of ``lost``,
    ``/admin/ec/rebuild``. After each generate the 14 shard files are
    hashed, after each rebuild the rebuilt ones, outside the timed calls."""
    c = _connect(url)
    shard = [f"{base}.ec{i:02d}" for i in range(14)]

    def step(name: str, path: str, cycle: dict) -> None:
        nonlocal c
        t = time.monotonic()
        try:
            status, body = call(c, "POST", path)
        except (OSError, http.client.HTTPException) as e:
            status, body = 0, repr(e).encode()
            c = _fresh(c)
        cycle["steps"].append((name, t, time.monotonic(), status))
        cycle[name] = json.loads(body) if status == 200 else {"error": body[:300].decode(
            "utf-8", "replace")}

    def one_cycle(start: float) -> dict:
        cycle = {"slot": start, "steps": []}
        step("generate", f"/admin/ec/generate?volume={vid}", cycle)
        cycle["after_generate"] = [_sha256(p) for p in shard]
        step("delete", f"/admin/ec/delete_shards?volume={vid}&shards="
             + ",".join(map(str, lost)), cycle)
        step("rebuild", f"/admin/ec/rebuild?volume={vid}", cycle)
        cycle["after_rebuild"] = {i: _sha256(shard[i]) for i in lost}
        return cycle

    try:
        warm = one_cycle(time.monotonic())
        conn.send(("ready", {"warmup": warm}))
        _, t0, t1 = conn.recv()
        cycles = []
        for k in range(slots):
            start = t0 + k * (t1 - t0) / slots
            _wait_until(start)
            cycles.append(one_cycle(start))
        return {"cycles": cycles, "done": time.monotonic()}
    finally:
        c.close()


def _sha256(path: str):
    """The file's sha256, or None where there is no file."""
    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
    except FileNotFoundError:
        return None
    return h.hexdigest()


def query_requests(fids: list, sql: str):
    """The request of the query cell: TPC-H Q6 as one ``/_query`` on an
    object; an answer is (status, rows, digest of the rows' text)."""
    from .reference.q6 import PROJECT, digest

    def one(c, i: int) -> tuple:
        status, body = call(c, "POST", "/_query",
                            json.dumps({"fid": fids[i], "input": "csv", "sql": sql}))
        if status != 200:
            return status, 0, body[:200].decode("utf-8", "replace")
        rows = json.loads(body)["rows"]
        return status, len(rows), digest([tuple(r[k] for k in PROJECT) for r in rows])

    return one


def closed_loop(conn, request: str, args: dict, urls: list, items: int, streams: int,
                seed: int) -> None:
    """``streams`` clients, each on its own kept-alive connection to
    ``urls[j % len(urls)]``, each sending its next request as soon as its
    last has answered; stream ``j`` picks its items uniformly from
    ``items`` with a generator of its own, seeded from ``seed`` and ``j``.
    First each stream sends one request, all at once (judged, not timed);
    then ``ready``. Each ``("go", t0, t1)`` is a window: every stream starts
    at ``t0`` and sends no request after ``t1``. A record per request:
    (item, sent, answered, status, size, digest). The window's records come
    back once every request sent in it has answered. ``("stop",)`` ends the
    task."""
    import random

    one = REQUESTS[request](**args)
    conns = [_connect(urls[j % len(urls)]) for j in range(streams)]
    picks = [random.Random(f"{seed}.stream.{j}") for j in range(streams)]

    def timed(j: int) -> tuple:
        item = picks[j].randrange(items)
        sent = time.monotonic()
        try:
            status, size, dig = one(conns[j], item)
        except (OSError, http.client.HTTPException) as e:
            conns[j] = _fresh(conns[j])
            status, size, dig = 0, 0, repr(e)
        return (item, sent, time.monotonic(), status, size, dig)

    def run(target, *more) -> list:
        recs: list = [[] for _ in range(streams)]
        pool = [threading.Thread(target=target, args=(j, recs[j], *more))
                for j in range(streams)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        return [r for rs in recs for r in rs]

    def stream(j: int, out: list, t0: float, t1: float) -> None:
        _wait_until(t0)
        while time.monotonic() < t1:
            out.append(timed(j))

    conn.send(("ready", {"warmup": run(lambda j, out: out.append(timed(j)))}))
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                return None
            conn.send(("window", run(stream, msg[1], msg[2])))
    finally:
        for c in conns:
            c.close()


REQUESTS = {"query": query_requests}


TASKS = {f.__name__: f for f in (upload_direct, upload_objects, q6_reference, seal_cycles,
                                 closed_loop)}


def _entry(conn, task: str, kwargs: dict) -> None:
    try:
        conn.send(("result", TASKS[task](conn, **kwargs)))
    except BaseException:  # reported to the parent, which fails the run
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


class Worker:
    """One spawned process running one task of ``TASKS``."""

    def __init__(self, task: str, **kwargs):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_entry, args=(child, task, kwargs), daemon=True)
        self.proc.start()
        child.close()
        self.task = task

    def _recv(self, timeout: float):
        if not self.conn.poll(timeout):
            raise TimeoutError(f"worker {self.task}: no message in {timeout} s")
        msg = self.conn.recv()
        if msg[0] == "error":
            raise RuntimeError(f"worker {self.task} failed:\n{msg[1]}")
        return msg

    def ready(self, timeout: float = 300.0):
        """The task's ``ready`` info."""
        kind, info = self._recv(timeout)
        if kind != "ready":
            raise RuntimeError(f"worker {self.task}: {kind} before ready")
        return info

    def go(self, t0: float, t1: float, *more) -> None:
        self.conn.send(("go", t0, t1, *more))

    def window(self, timeout: float):
        """The records of a closed loop's window."""
        kind, value = self._recv(timeout)
        if kind != "window":
            raise RuntimeError(f"worker {self.task}: {kind} instead of a window")
        return value

    def result(self, timeout: float = 600.0):
        kind, value = self._recv(timeout)
        if kind != "result":
            raise RuntimeError(f"worker {self.task}: {kind} instead of a result")
        self.close()
        return value

    def close(self) -> None:
        """End the process and wait for it."""
        if self.proc.is_alive():
            try:
                self.conn.send(("stop",))
            except OSError:
                pass
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self.conn.close()

