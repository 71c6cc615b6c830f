"""Cross-domain race detection: Eraser-style lockset analysis over the
loop/thread boundary.

Three rules, all built on the execution-domain classification in
``domaingraph.py`` and the lock declarations in ``lockgraph.py``:

- ``cross-domain-race``      — an attribute (or module global) written
  from functions spanning ≥ 2 execution domains whose guarding lockset
  intersection contains no *thread* lock.  This is the lockset rule of
  Eraser (Savage et al., TOCS 1997) at domain granularity: the GIL
  serializes bytecodes, not read-modify-write sequences, so an
  unlocked ``self.n += 1`` from the loop and a handler thread loses
  updates.  asyncio locks never count toward the intersection — they
  exclude coroutines on one loop, not OS threads.
- ``lock-held-across-await`` — a ``threading`` lock held at an
  ``await``/``async with``/``async for`` suspension point.  Any other
  thread contending that lock now waits on the loop's scheduling — and
  the loop itself deadlocks outright if a callback needs the lock —
  so the reactor stalls for every parked connection.
- ``loop-affine-escape``     — a loop-affine object (``AStreamBody``,
  per-loop pooled ``_AConn`` sockets, ``AioBoundedExecutor``) passed as
  a payload into a thread-domain dispatch (``Thread`` target args,
  executor submits).  These objects hold loop-bound resources
  (futures, reader/writer pairs) that off-loop code cannot legally
  drive.

The runtime half lives in ``util/racecheck.py``: ``SWEED_RACE_CHECK=1``
instruments the named shared structures with the same owner-domain +
lockset state machine, and ``tests/test_racecheck.py`` asserts every
dynamically observed race is in the static candidate set
(:func:`compute_race_report`) — the same static ⊇ dynamic protocol the
lock graph uses.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from . import Violation
from . import domaingraph as _dg
from .callgraph import CallGraph, FuncInfo, Project
from .lockgraph import LockGraphBuilder, THREAD_LOCK_KINDS

#: rule scope: the serving/storage planes plus the shared structures
#: they mutate (util/ caches+channels, stats/ rings+counters)
_SCOPES = (
    "cluster/", "server/", "storage/", "messaging/", "util/", "stats/"
)

#: constructors exempt from the write rule: the object is not yet
#: shared while it is being built (Eraser's initialization state)
_CTOR_NAMES = frozenset({"__init__", "__new__", "__post_init__", "__set_name__"})

#: terminal class names whose instances are loop-affine: they wrap
#: loop-bound resources (futures, stream reader/writer pairs, per-loop
#: pooled sockets) that must never be driven from a worker thread
LOOP_AFFINE_CLASSES = frozenset(
    {"AStreamBody", "_AConn", "AioBoundedExecutor"}
)

#: module-level lock factories recognized for ``with <name>:`` regions —
#: threading primitives only; an asyncio.Lock at module scope still
#: contributes nothing to a cross-thread lockset
_MODULE_LOCK_FACTORIES = frozenset({"make_lock", "make_rlock"})


@dataclass(frozen=True)
class WriteSite:
    relpath: str
    line: int
    fn: str           # function qualname
    domains: frozenset
    lockset: frozenset  # thread-kind lock node ids held at the write


@dataclass(frozen=True)
class RaceCandidate:
    """One shared location written from ≥ 2 domains with an empty
    thread-lockset intersection — the static finding AND the name the
    runtime sanitizer reports (``ClassName.attr``)."""

    name: str  # "ClassName.attr" or "module.py::global"
    domains: frozenset
    sites: tuple  # WriteSite, lexically ordered


class RaceChecker:
    def __init__(
        self,
        project: Project,
        lock_builder: Optional[LockGraphBuilder] = None,
        domains: Optional[_dg.DomainGraph] = None,
    ):
        project.index()
        self.project = project
        self.lb = lock_builder or LockGraphBuilder(project)
        self.cg: CallGraph = self.lb.cg
        self.dg = domains or _dg.compute_domains(project, self.cg)
        # (owner key, attr) → [WriteSite]; owner key is a class qualname
        # or "global:<modname>"
        self._writes: dict[tuple[str, str], list[WriteSite]] = {}
        self._await_v: list[Violation] = []
        self._escape_v: list[Violation] = []
        self._module_locks = self._collect_module_locks()
        self._collect()

    # -- helpers --------------------------------------------------------------
    def _collect_module_locks(self) -> dict[tuple[str, str], str]:
        """(modname, var) → lock node id for module-level threading locks
        (``_mu = threading.Lock()`` / ``make_lock(...)``), so a guarded
        lazy-init global is not reported as racy."""
        out: dict[tuple[str, str], str] = {}
        for mi in self.project.modules.values():
            for node in mi.tree.body:
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                ):
                    continue
                f = node.value.func
                is_lock = False
                if isinstance(f, ast.Attribute):
                    is_lock = (
                        isinstance(f.value, ast.Name)
                        and f.value.id == "threading"
                        and f.attr in ("Lock", "RLock")
                    )
                elif isinstance(f, ast.Name):
                    target = mi.symbols.get(f.id, ("", ""))[1]
                    is_lock = f.id in _MODULE_LOCK_FACTORIES or target in (
                        "threading.Lock", "threading.RLock"
                    )
                if is_lock:
                    name = node.targets[0].id
                    out[(mi.modname, name)] = f"{mi.modname}::{name}"
        return out

    def _lock_node(self, expr, fi: FuncInfo, env: dict) -> Optional[str]:
        node_id = self.lb._lock_node_for(expr, fi, env)
        if node_id is None and isinstance(expr, ast.Name):
            node_id = self._module_locks.get((fi.modname, expr.id))
        return node_id

    def _thread_locks(self, node_ids) -> frozenset:
        decls = self.lb.graph.decls
        return frozenset(
            n for n in node_ids
            if decls.get(n) is None or decls[n].kind in THREAD_LOCK_KINDS
        )

    def _held0(self, fi: FuncInfo) -> list[str]:
        """*_locked convention: the method runs with its class's locks
        already held (same seeding as the lock-order walk)."""
        if not (fi.class_qualname and "_locked" in fi.name):
            return []
        ci = self.project.classes.get(fi.class_qualname)
        if ci is None:
            return []
        return sorted(
            {
                node_id
                for (cls, _a), node_id in self.lb._decl_by_attr.items()
                if any(
                    m.qualname == cls
                    for m in self.project.mro(ci.qualname)
                )
            }
        )

    def _owner_for(
        self, target: ast.Attribute, fi: FuncInfo, env: dict
    ) -> Optional[str]:
        if isinstance(target.value, ast.Name) and target.value.id == "self":
            return fi.class_qualname
        t = self.cg.expr_type(target.value, fi, env)
        return t.cls

    # -- collection -----------------------------------------------------------
    def _collect(self) -> None:
        for fi in sorted(
            self.project.functions.values(), key=lambda f: f.qualname
        ):
            if not any(s in fi.relpath for s in _SCOPES):
                continue
            domains = self.dg.domains_of(fi.qualname)
            env = self.cg.local_types(fi)
            if domains and fi.name not in _CTOR_NAMES:
                self._walk_writes(
                    fi, fi.node, self._held0(fi), env, domains,
                    set(self._globals_declared(fi)),
                )
            if isinstance(fi.node, ast.AsyncFunctionDef):
                self._walk_awaits(fi, fi.node, self._held0(fi), env)
            if _dg.LOOP in domains:
                self._check_escapes(fi, env)

    @staticmethod
    def _globals_declared(fi: FuncInfo) -> list[str]:
        out = []
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Global):
                out.extend(node.names)
        return out

    def _walk_writes(
        self,
        fi: FuncInfo,
        node: ast.AST,
        held: list[str],
        env: dict,
        domains: frozenset,
        global_names: set,
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue  # separate scope, classified on its own
            if isinstance(child, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in child.items:
                    node_id = self._lock_node(item.context_expr, fi, env)
                    if node_id is not None:
                        acquired.append(node_id)
                inner = held + [a for a in acquired if a not in held]
                for stmt in child.body:
                    self._walk_writes(
                        fi, stmt, inner, env, domains, global_names
                    )
                continue
            targets: list[ast.expr] = []
            if isinstance(child, ast.Assign):
                targets = list(child.targets)
            elif isinstance(child, ast.AugAssign):
                targets = [child.target]
            elif isinstance(child, ast.AnnAssign) and child.value is not None:
                targets = [child.target]
            for tgt in targets:
                if isinstance(tgt, (ast.Tuple, ast.List)):
                    self._note_targets(
                        fi, tgt.elts, child.lineno, held, env, domains,
                        global_names,
                    )
                else:
                    self._note_targets(
                        fi, [tgt], child.lineno, held, env, domains,
                        global_names,
                    )
            self._walk_writes(fi, child, held, env, domains, global_names)

    def _note_targets(
        self, fi, tgts, lineno, held, env, domains, global_names
    ) -> None:
        lockset = self._thread_locks(held)
        for tgt in tgts:
            key = None
            if isinstance(tgt, ast.Attribute):
                owner = self._owner_for(tgt, fi, env)
                if owner is not None:
                    key = (owner, tgt.attr)
            elif isinstance(tgt, ast.Name) and tgt.id in global_names:
                key = (f"global:{fi.modname}", tgt.id)
            if key is None:
                continue
            self._writes.setdefault(key, []).append(
                WriteSite(fi.relpath, lineno, fi.qualname, domains, lockset)
            )

    # -- lock-held-across-await ----------------------------------------------
    def _walk_awaits(
        self, fi: FuncInfo, node: ast.AST, held: list[str], env: dict
    ) -> None:
        thread_held = [
            h for h in held if h in self._thread_locks(held)
        ]
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(child, (ast.Await, ast.AsyncFor)) and thread_held:
                self._await_violation(fi, child.lineno, thread_held[-1])
                # still descend: argument expressions may hold more locks
            if isinstance(child, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in child.items:
                    node_id = self._lock_node(item.context_expr, fi, env)
                    if node_id is not None:
                        acquired.append(node_id)
                if isinstance(child, ast.AsyncWith) and thread_held:
                    # entering `async with` awaits __aenter__
                    self._await_violation(
                        fi, child.lineno, thread_held[-1]
                    )
                inner = held + [a for a in acquired if a not in held]
                for stmt in child.body:
                    self._walk_awaits(fi, stmt, inner, env)
                continue
            self._walk_awaits(fi, child, held, env)

    def _await_violation(self, fi: FuncInfo, line: int, lock: str) -> None:
        key = (fi.relpath, line)
        if any((v.path, v.line) == key for v in self._await_v):
            return
        self._await_v.append(
            Violation(
                "lock-held-across-await",
                fi.relpath,
                line,
                f"threading lock {lock} held across an await point in "
                f"async def {fi.name}: every thread contending it now "
                "waits on loop scheduling and the reactor can deadlock "
                "on its own callback — release before awaiting, or use "
                "an asyncio.Lock for loop-side exclusion "
                "(docs/ANALYSIS.md)",
            )
        )

    # -- loop-affine-escape ----------------------------------------------------
    def _check_escapes(self, fi: FuncInfo, env: dict) -> None:
        for d in _dg.iter_dispatches(self.cg, fi, env):
            if d.domain == _dg.LOOP:
                continue
            for arg in d.arg_exprs:
                t = self.cg.expr_type(arg, fi, env)
                if not t.cls:
                    continue
                terminal = t.cls.rsplit(".", 1)[-1]
                if terminal not in LOOP_AFFINE_CLASSES:
                    continue
                self._escape_v.append(
                    Violation(
                        "loop-affine-escape",
                        fi.relpath,
                        d.call.lineno,
                        f"loop-affine {terminal} passed into a "
                        f"{d.domain}-domain {d.kind} dispatch: it wraps "
                        "loop-bound resources (futures, stream pairs, "
                        "per-loop pooled sockets) that off-loop code "
                        "cannot legally drive — read it on the loop and "
                        "hand bytes across instead (docs/ANALYSIS.md)",
                    )
                )

    # -- results ---------------------------------------------------------------
    def race_candidates(self) -> list[RaceCandidate]:
        out = []
        for (owner, attr), sites in sorted(self._writes.items()):
            all_domains = frozenset().union(*(s.domains for s in sites))
            if len(all_domains) < 2:
                continue
            common = sites[0].lockset
            for s in sites[1:]:
                common = common & s.lockset
            if common:
                continue
            terminal = owner.rsplit(".", 1)[-1]
            name = (
                f"{owner.split(':', 1)[1]}::{attr}"
                if owner.startswith("global:")
                else f"{terminal}.{attr}"
            )
            ordered = tuple(
                sorted(sites, key=lambda s: (s.relpath, s.line))
            )
            out.append(RaceCandidate(name, all_domains, ordered))
        return sorted(out, key=lambda c: (c.sites[0].relpath, c.sites[0].line))

    def violations(self) -> list[Violation]:
        out = list(self._await_v) + list(self._escape_v)
        for cand in self.race_candidates():
            first = cand.sites[0]
            others = ", ".join(
                sorted(
                    {
                        f"{s.relpath}:{s.line}"
                        for s in cand.sites[1:]
                    }
                )[:3]
            )
            doms = "+".join(sorted(cand.domains))
            out.append(
                Violation(
                    "cross-domain-race",
                    first.relpath,
                    first.line,
                    f"{cand.name} written from {doms} domains with no "
                    "common thread lock"
                    + (f" (other writes: {others})" if others else "")
                    + "; guard every write with one make_lock-named "
                    "lock, or confine the write to a single domain "
                    "(docs/ANALYSIS.md)",
                )
            )
        return out


def compute_race_report(project: Project) -> list[RaceCandidate]:
    """The full pre-waiver candidate set — the static side of the
    runtime sanitizer cross-check (static ⊇ dynamic)."""
    return RaceChecker(project).race_candidates()


def check_project(
    project: Project, lock_builder: Optional[LockGraphBuilder] = None
) -> list[Violation]:
    return RaceChecker(project, lock_builder).violations()
