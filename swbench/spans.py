"""The program's spans over a measured window: where the readers find them,
and the arithmetic they share.

A span is a dict with ``name``, ``start_ns`` and ``end_ns`` (ns since the
epoch: the clock in which the profiler stamps device events), ``span_id``,
``parent_id``, ``thread`` and ``tags``, as the port's
``seaweedfs_tpu_torch/stats/trace.py`` makes them. ``of_run`` takes a run's
spans from ``run["spans"]`` where the run recorded them (a recorder open
over the window), else from the program's span ring as the run left it:
the process's last spans, among them the window's last ones. A server span
the ring holds has all of its descendants held if it started after the
oldest held span ended (``horizon``). A program whose spans carry no
``end_ns`` gives no spans, so its readers read nothing.

Which server spans are the window's: where ``run["window_ns"]`` is given,
those that started and ended in it; else the last ones the program served,
as many as the run counted in the window (``run["work"]``).
"""

from __future__ import annotations

import collections

QUERY = "POST /_query"
GENERATE = "POST /admin/ec/generate"
REBUILD = "POST /admin/ec/rebuild"
NO_SPAN = "no program span open"


def of_run(run: dict) -> tuple:
    """(spans in the order they finished, horizon ns or None)."""
    if run.get("spans") is not None:
        return run["spans"], None
    try:
        from seaweedfs_tpu_torch.stats import trace
    except ImportError:
        return [], None
    st = trace.RING.stats()
    spans = [s for s in trace.RING.snapshot(st["capacity"]) if "end_ns" in s]
    horizon = spans[0]["end_ns"] if spans and st["dropped"] else None
    return spans, horizon


def union_ns(intervals) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    total, cursor = 0, None
    for s, e in sorted(intervals):
        if cursor is None or s > cursor:
            total += e - s
            cursor = e
        elif e > cursor:
            total += e - cursor
            cursor = e
    return total


def self_ns(span: dict, children: list) -> int:
    """The span's duration less the union of its children's intervals
    within it."""
    s, e = span["start_ns"], span["end_ns"]
    inside = [(max(c["start_ns"], s), min(c["end_ns"], e)) for c in children
              if c["end_ns"] > s and c["start_ns"] < e]
    return e - s - union_ns(inside)


class Tree:
    """Parent links of a span list."""

    def __init__(self, spans: list):
        self.kids = collections.defaultdict(list)
        for s in spans:
            self.kids[s["parent_id"]].append(s)

    def under(self, span: dict) -> list:
        """Every descendant of ``span``."""
        out, todo = [], [span["span_id"]]
        while todo:
            for s in self.kids.get(todo.pop(), ()):
                out.append(s)
                todo.append(s["span_id"])
        return out


def window_servers(run: dict, spans: list, name: str, count: int, late: int = 0) -> list:
    """The window's server spans called ``name``: those inside
    ``run["window_ns"]``, else the last ``count`` finished less the
    ``late`` that finished last (answered after the window closed)."""
    found = [s for s in spans if s["name"] == name]
    if run.get("window_ns"):
        t0, t1 = run["window_ns"]
        return [s for s in found if t0 <= s["start_ns"] and s["end_ns"] <= t1]
    if count <= 0:
        return []
    last = sorted(found[-count:], key=lambda s: s["end_ns"])
    return last[:len(last) - late]


def held(roots: list, horizon) -> list:
    """The roots whose descendants are all held."""
    return [s for s in roots if horizon is None or s["start_ns"] > horizon]


def _queries(run: dict) -> tuple:
    spans, horizon = of_run(run)
    work = run.get("work") or {}
    base = window_servers(run, spans, QUERY, work.get("requests", 0),
                          work.get("answered_after_window", 0))
    return held([s for s in base if s["tags"].get("status") == 200], horizon), Tree(spans)


def query_self_ms(run: dict, name: str):
    """Mean self time, in ms, of the spans called ``name`` under each of
    the window's answered ``/_query`` server spans; None where none of them
    has one."""
    base, tree = _queries(run)
    total, seen = 0, False
    for q in base:
        for s in tree.under(q):
            if s["name"] == name:
                total += self_ns(s, tree.kids.get(s["span_id"], []))
                seen = True
    return total / len(base) / 1e6 if seen else None


def proxy_wait_ms(run: dict):
    """Mean time, in ms, from the native engine's stamp of a proxied
    ``/_query`` to the daemon's server span of it; None where no span
    carries the stamp."""
    base, _ = _queries(run)
    waits = [q["start_ns"] - q["tags"]["engine_ns"] for q in base if "engine_ns" in q["tags"]]
    return sum(waits) / len(waits) / 1e6 if waits else None


def seal_s_per_cycle(run: dict, name: str):
    """Seconds per cycle of the spans called ``name`` under the window's
    generate and rebuild server spans: their summed durations over the
    generates that ended in the window; None where there are none."""
    spans, horizon = of_run(run)
    work = run.get("work") or {}
    gens = window_servers(run, spans, GENERATE, work.get("generates", 0))
    rebs = window_servers(run, spans, REBUILD, work.get("rebuilds", 0))
    tree = Tree(spans)
    per, seen = 0.0, False
    for roots, weight in ((gens, 1.0), (rebs, len(rebs) / len(gens) if gens else 0.0)):
        whole = held(roots, horizon)
        named = [s for r in whole for s in tree.under(r) if s["name"] == name]
        if named:
            seen = True
            per += weight * sum(s["end_ns"] - s["start_ns"] for s in named) / len(whole) / 1e9
    return per if seen and gens else None


def idle_spans(events: list, spans: list, t0: int, t1: int, top: int = 10) -> list:
    """The card's idle time in [t0, t1] by the program's span open at each
    idle instant: ``events`` are the device's ``(name, start ns, end ns)``;
    an idle instant goes to the innermost open span of each thread that has
    one, split evenly among those threads, or to ``no program span open``.
    Returns [[span name, seconds]]: the ``top`` names by time, then the
    instants no span covered."""
    busy = sorted((max(s, t0), min(e, t1)) for _, s, e in events if e > t0 and s < t1)
    idle, cursor = [], t0
    for s, e in busy:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < t1:
        idle.append((cursor, t1))
    marks = []
    for i, sp in enumerate(spans):
        s, e = max(sp["start_ns"], t0), min(sp["end_ns"], t1)
        if s < e:
            marks.append((s, 1, i))
            marks.append((e, 0, i))
    marks.sort()
    marks.append((t1, 0, -1))
    by_name: collections.Counter = collections.Counter()
    open_by_thread: dict = collections.defaultdict(set)
    at, k = t0, 0  # k: the first idle interval that may still overlap
    for t, opening, i in marks:
        if t > at:
            while k < len(idle) and idle[k][1] <= at:
                k += 1
            gap, j = 0, k
            while j < len(idle) and idle[j][0] < t:
                gap += min(idle[j][1], t) - max(idle[j][0], at)
                j += 1
            if gap > 0:
                inner = [max(ids, key=lambda x: (spans[x]["start_ns"], -spans[x]["end_ns"]))
                         for ids in open_by_thread.values() if ids]
                if inner:
                    for x in inner:
                        by_name[spans[x]["name"]] += gap / len(inner)
                else:
                    by_name[NO_SPAN] += gap
            at = t
        if i >= 0:
            thread = open_by_thread[spans[i]["thread"]]
            if opening:
                thread.add(i)
            else:
                thread.discard(i)
    named = [[n, ns / 1e9] for n, ns in by_name.most_common() if n != NO_SPAN][:top]
    return named + [[NO_SPAN, by_name[NO_SPAN] / 1e9]]
