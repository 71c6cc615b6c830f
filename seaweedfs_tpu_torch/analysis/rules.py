"""The sweedlint rules.

Each rule is a singleton object with:

- ``name``       — rule id used in findings and suppression comments;
- ``applies_to(relpath)`` — scope filter (some rules only patrol the
  layers where their bug class lives);
- ``check(tree, relpath)`` — AST pass returning raw findings
  (suppressions are applied by the caller).

Adding a rule: write the class, append an instance to ``RULES``, add a
fixture pair under ``tests/fixtures/sweedlint/`` and a section in
``docs/ANALYSIS.md``.
"""

from __future__ import annotations

import ast
from typing import Optional

from . import Violation

# -- shared helpers -----------------------------------------------------------

#: dict-like locals/attributes whose values come off the wire (query
#: strings, parsed headers, request dicts).  int()/float() on anything
#: derived from these is the strict-int bug class.
_REQUESTISH = frozenset(
    {
        "q",
        "qs",
        "query",
        "req",
        "request",
        "params",
        "form",
        "headers",
        "header",
        "hdrs",
        "args",
    }
)

_LOCK_FACTORIES = frozenset(
    {
        "Lock",
        "RLock",
        "Condition",
        # util/locks.py OrderedLock constructors — same semantics, plus the
        # SWEED_LOCK_CHECK=1 runtime order sanitizer.
        "make_lock",
        "make_rlock",
        "make_condition",
        "OrderedLock",
    }
)


def _terminal_name(node: ast.AST) -> Optional[str]:
    """'q' for Name q, 'headers' for self.headers / h.headers chains."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _func_name(call: ast.Call) -> str:
    return _terminal_name(call.func) or ""


def _is_self_attr(node: ast.AST) -> Optional[str]:
    """'_lock' for ``self._lock``; None for anything else."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


# -- rule 1: lock-discipline --------------------------------------------------


class LockDiscipline:
    """Infer which ``self._*`` attributes a class guards with
    ``with self.<lock>:`` and flag touches of those attributes outside the
    lock.

    Guard inference: an attribute is *guarded by* lock L when any method
    other than ``__init__`` writes it inside ``with self.L:``.  Every
    read or write of a guarded attribute outside L (again excluding
    ``__init__``, which runs before the object is shared) is a finding.

    Convention hooks the checker understands:
    - methods whose name contains ``_locked`` are assumed to be called
      with every class lock already held (document that in the method's
      docstring) — accesses inside them are treated as guarded;
    - functions nested inside a method (thread targets, callbacks) run
      later, so locks held at definition time are NOT considered held
      inside them.
    """

    name = "lock-discipline"

    _SCOPES = ("server/", "cluster/", "storage/", "messaging/")

    def applies_to(self, relpath: str) -> bool:
        return any(s in relpath for s in self._SCOPES)

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(node, relpath))
        return out

    # one access record: (attr, lineno, is_write, frozenset of held locks)
    def _check_class(
        self, cls: ast.ClassDef, relpath: str
    ) -> list[Violation]:
        lock_attrs = self._find_lock_attrs(cls)
        if not lock_attrs:
            return []
        accesses: list[tuple[str, int, bool, frozenset]] = []
        for item in cls.body:
            if not isinstance(
                item, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if item.name in ("__init__", "__new__"):
                continue
            assume_all = "_locked" in item.name
            held0 = frozenset(lock_attrs) if assume_all else frozenset()
            self._walk(item.body, held0, lock_attrs, accesses)
        guards: dict[str, set[str]] = {}
        for attr, _line, is_write, held in accesses:
            if is_write:
                for lock in held:
                    guards.setdefault(attr, set()).add(lock)
        out = []
        seen: set[tuple[str, int]] = set()
        for attr, line, _is_write, held in accesses:
            locks = guards.get(attr)
            if not locks or locks & held:
                continue
            if (attr, line) in seen:
                continue
            seen.add((attr, line))
            lock = sorted(locks)[0]
            out.append(
                Violation(
                    self.name,
                    relpath,
                    line,
                    f"self.{attr} is written under self.{lock} elsewhere "
                    f"in {cls.name} but touched here without it",
                )
            )
        return out

    @staticmethod
    def _find_lock_attrs(cls: ast.ClassDef) -> set[str]:
        locks: set[str] = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            call = node.value
            if not (
                isinstance(call, ast.Call)
                and _func_name(call) in _LOCK_FACTORIES
            ):
                continue
            for tgt in node.targets:
                attr = _is_self_attr(tgt)
                if attr:
                    locks.add(attr)
        return locks

    def _walk(self, body, held, lock_attrs, accesses) -> None:
        for stmt in body:
            self._visit(stmt, held, lock_attrs, accesses)

    def _visit(self, node, held, lock_attrs, accesses) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later (thread target); locks held NOW are
            # not held THEN
            self._walk(node.body, frozenset(), lock_attrs, accesses)
            return
        if isinstance(node, ast.Lambda):
            self._visit(node.body, frozenset(), lock_attrs, accesses)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set()
            for item in node.items:
                attr = _is_self_attr(item.context_expr)
                if attr in lock_attrs:
                    acquired.add(attr)
                else:
                    self._visit(
                        item.context_expr, held, lock_attrs, accesses
                    )
            self._walk(node.body, held | acquired, lock_attrs, accesses)
            return
        if isinstance(node, ast.Attribute):
            attr = _is_self_attr(node)
            if attr and attr not in lock_attrs:
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                accesses.append((attr, node.lineno, is_write, held))
            self._visit(node.value, held, lock_attrs, accesses)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, lock_attrs, accesses)


# -- rule 2: durability -------------------------------------------------------


class Durability:
    """In the volume-data layers (``storage/``, ``ec/``) every
    ``os.rename`` / ``os.replace`` / ``os.unlink`` / ``os.remove``
    touches a volume, shard, or index file — exactly the renames whose
    crash-atomicity PR 1 moved into the StagedCommit protocol.  New state
    transitions must go through ``storage/commit.py`` (or carry a
    suppression explaining why a raw rename cannot tear)."""

    name = "durability"

    _SCOPES = ("storage/", "ec/")
    _EXEMPT = ("storage/commit.py",)  # the protocol implementation itself
    _CALLS = frozenset({"rename", "replace", "unlink", "remove"})

    def applies_to(self, relpath: str) -> bool:
        if any(relpath.endswith(e) for e in self._EXEMPT):
            return False
        return any(s in relpath for s in self._SCOPES)

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in self._CALLS
                and isinstance(f.value, ast.Name)
                and f.value.id == "os"
            ):
                out.append(
                    Violation(
                        self.name,
                        relpath,
                        node.lineno,
                        f"os.{f.attr} on a volume-layer path outside "
                        "StagedCommit (storage/commit.py); a crash here "
                        "can tear the volume state",
                    )
                )
        return out


# -- rule 3: strict-int -------------------------------------------------------


class StrictInt:
    """Bare ``int()`` / ``float()`` on values pulled from request-shaped
    dicts (query params, headers, request bodies).  Plain ``int()``
    accepts ``'+5'``, ``' 5 '``, ``'1_0'`` and unicode digits — inputs
    AWS-compatible endpoints must reject and tolerant endpoints must
    clamp.  Use ``util.parsers.parse_ascii_uint`` (strict, raises) or
    ``util.parsers.tolerant_uint`` (falls back to a default) instead."""

    name = "strict-int"

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if not (
                isinstance(node.func, ast.Name)
                and node.func.id in ("int", "float")
                and len(node.args) == 1  # int(s, 16) is hex framing, not
                and not node.keywords  # a decimal query int
            ):
                continue
            src = self._request_source(node.args[0])
            if src:
                out.append(
                    Violation(
                        self.name,
                        relpath,
                        node.lineno,
                        f"bare {node.func.id}() on request-derived value "
                        f"({src}); use util.parsers.parse_ascii_uint / "
                        "tolerant_uint",
                    )
                )
        return out

    @staticmethod
    def _request_source(expr: ast.AST) -> Optional[str]:
        """A description of the request-ish derivation inside ``expr``
        (``q.get(...)``, ``query[...]``), or None."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "get"
                    and _terminal_name(f.value) in _REQUESTISH
                ):
                    return f"{_terminal_name(f.value)}.get(...)"
            if isinstance(node, ast.Subscript):
                base = _terminal_name(node.value)
                if base in _REQUESTISH:
                    return f"{base}[...]"
        return None


# -- rule 4: broad-except -----------------------------------------------------


class BroadExcept:
    """Two shapes of the over-broad ``except`` bug class:

    - **silent swallow** — ``except Exception:`` (or bare ``except:``)
      whose body is only ``pass`` / ``continue``: the failure vanishes
      with no log line and no error path;
    - **auth span** — ``except Exception`` / ``except ValueError`` whose
      ``try`` body includes auth/context construction: an auth failure
      raised inside gets relabeled as whatever error the handler was
      written for (the streaming-scope bug PR 1 fixed).
    """

    name = "broad-except"

    _BROAD = frozenset({"Exception", "BaseException"})
    _AUTH_MARKERS = ("auth", "streaming_context", "signing_key")

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            try_calls_auth = self._spans_auth(node.body)
            for handler in node.handlers:
                types = self._handler_types(handler)
                broad = not types or types & self._BROAD
                if broad and self._is_silent(handler.body):
                    out.append(
                        Violation(
                            self.name,
                            relpath,
                            handler.lineno,
                            "except Exception swallows silently (body is "
                            "only pass/continue); log it or narrow the "
                            "exception type",
                        )
                    )
                elif try_calls_auth and (
                    broad or "ValueError" in types
                ):
                    out.append(
                        Violation(
                            self.name,
                            relpath,
                            handler.lineno,
                            "broad except spans auth/context construction"
                            " in its try body; an auth failure would be "
                            "mislabeled as this handler's error",
                        )
                    )
        return out

    @staticmethod
    def _handler_types(handler: ast.ExceptHandler) -> set[str]:
        t = handler.type
        if t is None:
            return set()
        nodes = t.elts if isinstance(t, ast.Tuple) else [t]
        return {n for n in (_terminal_name(e) for e in nodes) if n}

    @staticmethod
    def _is_silent(body: list[ast.stmt]) -> bool:
        return all(
            isinstance(s, (ast.Pass, ast.Continue)) for s in body
        )

    def _spans_auth(self, body: list[ast.stmt]) -> bool:
        """True when the try body mixes auth/context construction with
        other work.  A try whose ONLY call is the auth construction is the
        sanctioned narrow shape (the PR 1 fix) and is not flagged."""
        auth_calls = other_calls = 0
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    fn = _func_name(node).lower()
                    if any(m in fn for m in self._AUTH_MARKERS):
                        auth_calls += 1
                    else:
                        other_calls += 1
        return auth_calls > 0 and (other_calls > 0 or len(body) > 1)


# -- rule 5: resource-leak ----------------------------------------------------


class ResourceLeak:
    """``open()`` bound to a name with no visible close path.

    Accepted shapes: ``with open(...) as f``; a local ``f = open(...)``
    whose enclosing function also calls ``f.close()`` (finally blocks and
    error paths count); ``self._f = open(...)`` in a class that somewhere
    calls ``self._f.close()`` (the long-lived daemon-handle pattern).
    Anything else leaks the fd on the error path at best."""

    name = "resource-leak"

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out: list[Violation] = []
        # enclosing scope for locals = nearest function; for self attrs =
        # nearest class
        self._scan(tree, tree, None, out, relpath)
        return out

    def _scan(self, node, func_scope, class_scope, out, relpath) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._scan(child, func_scope, child, out, relpath)
            elif isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                self._scan(child, child, class_scope, out, relpath)
            else:
                if isinstance(child, ast.Assign):
                    self._check_assign(
                        child, func_scope, class_scope, out, relpath
                    )
                self._scan(child, func_scope, class_scope, out, relpath)

    def _check_assign(
        self, node: ast.Assign, func_scope, class_scope, out, relpath
    ) -> None:
        v = node.value
        if not (
            isinstance(v, ast.Call)
            and isinstance(v.func, ast.Name)
            and v.func.id == "open"
        ):
            return
        if len(node.targets) != 1:
            return
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name):
            if not self._closes_name(func_scope, tgt.id):
                out.append(
                    Violation(
                        self.name,
                        relpath,
                        node.lineno,
                        f"open() bound to {tgt.id!r} with no .close() in "
                        "the enclosing function; use `with` or close on "
                        "every path",
                    )
                )
        else:
            attr = _is_self_attr(tgt)
            if attr is not None:
                scope = class_scope or func_scope
                if not self._closes_self_attr(scope, attr):
                    out.append(
                        Violation(
                            self.name,
                            relpath,
                            node.lineno,
                            f"open() bound to self.{attr} but no "
                            f"self.{attr}.close() anywhere in the class; "
                            "register a close for the daemon lifecycle",
                        )
                    )

    @staticmethod
    def _closes_name(scope, name: str) -> bool:
        for node in ast.walk(scope):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "close"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == name
            ):
                return True
        return False

    @staticmethod
    def _closes_self_attr(scope, attr: str) -> bool:
        for node in ast.walk(scope):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "close"
                and _is_self_attr(node.func.value) == attr
            ):
                return True
        return False


# -- rule 6: bounded-window ---------------------------------------------------


class BoundedWindow:
    """Concurrency without a visible bound. Two shapes:

    - ``ThreadPoolExecutor()`` with no ``max_workers`` — the pool sizes
      itself from the host's CPU count, so the same code ships a window
      of 4 on the laptop and 64 in production (and each worker in the
      data plane pins a chunk in memory: the window IS the memory bound,
      docs/PERF.md);
    - ``pool.submit(...)`` inside a ``for``/``while`` loop where ``pool``
      is a raw ``ThreadPoolExecutor`` — submissions queue without limit,
      so a large input materializes entirely in the pool's work queue.
      Route the loop through ``util.pipeline.BoundedExecutor`` /
      ``prefetch_iter`` (which block at the window), or carry a
      suppression naming the external bound.

    ``util/pipeline.py`` itself is exempt: it is the primitive the rule
    tells everyone else to use."""

    name = "bounded-window"

    _EXEMPT = ("util/pipeline.py",)

    def applies_to(self, relpath: str) -> bool:
        return not any(relpath.endswith(e) for e in self._EXEMPT)

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and self._is_tpe(node):
                if not node.args and not any(
                    kw.arg == "max_workers" for kw in node.keywords
                ):
                    out.append(
                        Violation(
                            self.name,
                            relpath,
                            node.lineno,
                            "ThreadPoolExecutor() without max_workers "
                            "sizes itself from the host CPU count; pass "
                            "an explicit window",
                        )
                    )
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_submit_loops(node, relpath))
        return out

    @staticmethod
    def _is_tpe(call: ast.Call) -> bool:
        return _func_name(call) == "ThreadPoolExecutor"

    def _check_submit_loops(self, func, relpath) -> list[Violation]:
        pools: set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ) and self._is_tpe(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        pools.add(tgt.id)
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if (
                        isinstance(item.context_expr, ast.Call)
                        and self._is_tpe(item.context_expr)
                        and isinstance(item.optional_vars, ast.Name)
                    ):
                        pools.add(item.optional_vars.id)
        if not pools:
            return []
        out = []
        for node in ast.walk(func):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            for call in ast.walk(node):
                if (
                    isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "submit"
                    and isinstance(call.func.value, ast.Name)
                    and call.func.value.id in pools
                ):
                    out.append(
                        Violation(
                            self.name,
                            relpath,
                            call.lineno,
                            f"{call.func.value.id}.submit in a loop queues "
                            "without an in-flight bound; use util.pipeline."
                            "BoundedExecutor/prefetch_iter or suppress "
                            "naming the external bound",
                        )
                    )
        return out


class UnboundedRetry:
    """A ``while True`` loop that performs network I/O and paces itself
    with a FIXED ``time.sleep(<literal>)`` is an unbounded, non-backing-off
    retry: when the peer dies, the thread hammers it at a constant rate
    forever, and on a fleet-wide outage every such loop re-collides in
    lockstep. The sanctioned forms (util/retry.py) are ``retry_call`` —
    bounded attempts + jittered exponential backoff — or ``backoff_delays``
    feeding the sleep for loops that legitimately never exit (peer-follow,
    sync). Loops gated on an Event (``while not stop.is_set()``) or
    sleeping a computed/variable delay are not flagged — the bound or the
    backoff is visible.

    ``util/retry.py`` itself is exempt: it is the primitive the rule tells
    everyone else to use."""

    name = "unbounded-retry"

    _EXEMPT = ("util/retry.py",)

    _NET_CALLS = {
        "http_json", "http_bytes", "http_bytes_headers",
        "http_stream_request", "http_stream_response", "urlopen",
        "create_connection",
    }

    def applies_to(self, relpath: str) -> bool:
        return not any(relpath.endswith(e) for e in self._EXEMPT)

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.While):
                continue
            if not self._is_while_true(node):
                continue
            net_line = self._first_net_call(node)
            sleep = self._fixed_sleep(node)
            if net_line is not None and sleep is not None:
                out.append(
                    Violation(
                        self.name,
                        relpath,
                        sleep,
                        "while-True network loop retries at a fixed "
                        "interval with no attempt bound or backoff; use "
                        "util.retry.retry_call, or pace the loop with "
                        "util.retry.backoff_delays",
                    )
                )
        return out

    @staticmethod
    def _is_while_true(node: ast.While) -> bool:
        t = node.test
        return isinstance(t, ast.Constant) and bool(t.value) is True

    def _first_net_call(self, loop: ast.While) -> Optional[int]:
        for n in ast.walk(loop):
            if isinstance(n, ast.Call) and _func_name(n) in self._NET_CALLS:
                return n.lineno
        return None

    @staticmethod
    def _fixed_sleep(loop: ast.While) -> Optional[int]:
        """Line of a ``[time.]sleep(<numeric literal>)`` in the loop body —
        a constant interval, i.e. visibly no backoff. Variable or computed
        delays pass (the schedule may grow; proving otherwise is the
        reviewer's job, not the lint's)."""
        for n in ast.walk(loop):
            if not (isinstance(n, ast.Call) and _func_name(n) == "sleep"):
                continue
            if n.args and isinstance(n.args[0], ast.Constant) and isinstance(
                n.args[0].value, (int, float)
            ):
                return n.lineno
        return None


class MetricCardinality:
    """Metric label values must come from bounded sets: the registry holds
    one series per distinct label combination FOREVER, so labeling a
    counter with a per-request identifier (path, fid, trace id, volume
    id) turns it into a memory leak and a /metrics payload bomb — the
    exact failure Prometheus docs warn about under "cardinality".

    Flags ``inc()`` / ``set()`` / ``observe()`` / ``time()`` keyword
    arguments whose NAME — or whose value's terminal identifier, including
    through f-strings — names such an identifier. Bounded dynamic labels
    (a fleet member's url, a configured sync direction's name) pass: the
    rule keys on identifier names, not on dynamism — proving a variable
    bounded is the reviewer's job, catching the known-unbounded ids is
    the lint's. Exemplar keywords on the histogram API itself
    (``observe(v, trace_id=...)``) route trace ids BESIDE the label set,
    not into it, so ``stats/`` is exempt."""

    name = "metric-cardinality"

    _METHODS = frozenset({"inc", "set", "observe", "time"})

    #: per-request / per-object identifier names — unbounded by
    #: construction. Deliberately small: url/member/direction/name label
    #: bounded fleets and configured directions today.
    _UNBOUNDED = frozenset(
        {
            "path",
            "full_path",
            "file_path",
            "filepath",
            "fid",
            "file_id",
            "nid",
            "needle_id",
            "trace_id",
            "traceid",
            "span_id",
            "vid",
            "volume_id",
            "object_key",
        }
    )

    _EXEMPT = ("stats/histogram.py", "stats/metrics.py", "stats/trace.py")

    def applies_to(self, relpath: str) -> bool:
        return not any(relpath.endswith(e) for e in self._EXEMPT)

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self._METHODS
                and node.keywords
            ):
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue  # **labels passthrough: the source site is
                    # where the identifier enters, flag there
                bad = kw.arg if kw.arg in self._UNBOUNDED else (
                    self._unbounded_value(kw.value)
                )
                if bad:
                    out.append(
                        Violation(
                            self.name,
                            relpath,
                            node.lineno,
                            f"metric label {kw.arg}={bad!r} is a "
                            "per-request identifier: every distinct value "
                            "becomes a series the registry holds forever; "
                            "put it in a span tag or log line instead",
                        )
                    )
        return out

    def _unbounded_value(self, value: ast.AST) -> Optional[str]:
        """Terminal identifier of the label VALUE when it names a known
        per-request id: ``op=path``, ``op=entry.full_path``, and f-strings
        interpolating either (``op=f"get {path}"``)."""
        if isinstance(value, ast.JoinedStr):
            for part in value.values:
                if isinstance(part, ast.FormattedValue):
                    hit = self._unbounded_value(part.value)
                    if hit:
                        return hit
            return None
        t = _terminal_name(value)
        return t if t in self._UNBOUNDED else None


class MaintenanceWithoutInterlock:
    """Background maintenance — EC encodes/decodes, vacuum, tier moves,
    replica moves — competes with serving traffic for the same spindles
    and NICs. A LOOP that schedules maintenance over multiple volumes can
    saturate the cluster exactly when a zipf storm needs it most, so any
    such loop must consult the load interlock
    (cluster/lifecycle.py ``LoadInterlock.maintenance_allowed`` — the
    admission controller's inflight gauge vs the serving watermark)
    between iterations, or carry a reasoned waiver explaining why some
    OTHER throttle bounds it (an operator typing one command IS an
    interlock; a daemon loop is not). One finding per loop, anchored on
    the first maintenance call inside it."""

    name = "maintenance-without-interlock"

    #: terminal call names that schedule maintenance work
    _MAINT = frozenset(
        {
            "ec_encode",
            "ec_encode_fleet",
            "ec_decode",
            "ec_rebuild",
            "volume_tier_upload",
            "volume_tier_download",
            "volume_move",
            "volume_vacuum",
            "tier_upload",
            "tier_download",
        }
    )
    #: consulting any of these inside the loop satisfies the rule
    _CONSULT = frozenset({"maintenance_allowed", "allow_maintenance"})

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out: list[Violation] = []
        seen_lines: set[int] = set()
        for node in ast.walk(tree):
            if not isinstance(node, (ast.For, ast.While)):
                continue
            maint_line = None
            consults = False
            for n in ast.walk(node):
                if not isinstance(n, ast.Call):
                    continue
                fn = _func_name(n)
                if fn in self._MAINT and maint_line is None:
                    maint_line = n.lineno
                if fn in self._CONSULT:
                    consults = True
            if maint_line is None or consults:
                continue
            if maint_line in seen_lines:
                continue  # nested loops: one finding per call site
            seen_lines.add(maint_line)
            out.append(
                Violation(
                    self.name,
                    relpath,
                    maint_line,
                    "loop schedules maintenance without consulting the "
                    "load interlock; call "
                    "LoadInterlock.maintenance_allowed() between "
                    "iterations (cluster/lifecycle.py) or waive with the "
                    "throttle that bounds this loop",
                )
            )
        return out


class DeadlinePropagation:
    """Cross-daemon HTTP done with raw stdlib primitives
    (``urllib.request.urlopen``, bare ``http.client`` connections) or the
    ``requests`` package bypasses the deadline-propagating transports, so
    the caller's ``X-Sweed-Deadline`` dies at that hop: the downstream
    daemon keeps grinding on work whose requester already gave up, which
    is exactly the tail-amplification the cross-daemon deadline exists to
    stop. The sanctioned transports — ``server.http_util`` on threads,
    ``server.aio_transport`` on the loop — inject the ambient deadline
    header and clamp the socket timeout to the remaining budget on every
    request.

    The two transport modules themselves are exempt (they wrap the raw
    primitives to DO the propagation). Hops that must NOT carry the
    internal deadline — egress to third-party services like cloud sinks
    or webhook endpoints — keep the raw call and waive with that reason.
    """

    name = "deadline-not-propagated"

    _EXEMPT = ("server/http_util.py", "server/aio_transport.py")

    #: raw call names that open an HTTP exchange without the deadline
    _RAW = frozenset({"urlopen", "HTTPConnection", "HTTPSConnection"})

    #: requests.<verb>(...) — same bypass, different package
    _REQUESTS_VERBS = frozenset(
        {"get", "post", "put", "delete", "head", "patch", "request"}
    )

    def applies_to(self, relpath: str) -> bool:
        return not any(relpath.endswith(e) for e in self._EXEMPT)

    def check(self, tree: ast.Module, relpath: str) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if self._is_raw_http(node):
                out.append(
                    Violation(
                        self.name,
                        relpath,
                        node.lineno,
                        "raw HTTP call drops the ambient deadline; use "
                        "server.http_util (threads) or "
                        "server.aio_transport (event loop) so "
                        "X-Sweed-Deadline and the timeout clamp ride "
                        "along, or waive with the reason this hop must "
                        "not carry the internal deadline",
                    )
                )
        return out

    def _is_raw_http(self, call: ast.Call) -> bool:
        name = _func_name(call)
        if name in self._RAW:
            return True
        # requests.get(...) / requests.post(...) — only when the receiver
        # is literally the requests module, so obj.get(key) stays quiet
        f = call.func
        return (
            isinstance(f, ast.Attribute)
            and f.attr in self._REQUESTS_VERBS
            and isinstance(f.value, ast.Name)
            and f.value.id == "requests"
        )


RULES = [
    LockDiscipline(),
    Durability(),
    StrictInt(),
    BroadExcept(),
    ResourceLeak(),
    BoundedWindow(),
    UnboundedRetry(),
    MetricCardinality(),
    MaintenanceWithoutInterlock(),
    DeadlinePropagation(),
]
