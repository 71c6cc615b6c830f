"""sweedlint — project-specific static analysis for seaweedfs_tpu_torch.

Every rule encodes a bug class this repo has actually shipped (see
docs/ANALYSIS.md for the history behind each one).

Per-file rules (``rules.py``):

- ``lock-discipline`` — attributes written under ``with self._lock`` must
  not be touched outside it (lightweight race detector).
- ``durability``     — renames/unlinks of volume/shard/index files must
  flow through the StagedCommit protocol in ``storage/commit.py``.
- ``strict-int``     — ``int()``/``float()`` on request/query/header
  values must use the shared strict parsers in ``util/parsers.py``.
- ``broad-except``   — ``except Exception`` must not swallow silently or
  span auth/context construction.
- ``resource-leak``  — ``open()`` handles need ``with``, a tracked
  ``.close()``, or an ownership transfer the code can show.
- ``bounded-window`` — raw unbounded ``ThreadPoolExecutor`` submit loops
  must go through ``util/pipeline.py``.

Interprocedural rules (``callgraph.py`` + ``lockgraph.py`` +
``taint.py``), which see the whole project at once:

- ``lock-order``          — a cycle in the lock acquisition-order graph
  (potential ABBA deadlock), computed transitively through the call
  graph.
- ``blocking-under-lock`` — a network/disk/sleep/``Future.result`` call
  reachable while a lock is held.
- ``blocking-on-loop``    — the same blocking calls reachable from an
  ``async def`` body (they stall the event-loop reactor for every
  connection it serves); awaited calls are exempt.
- ``tainted-size``        — a wire-derived value flowing into a
  seek/read/slice/allocation size without ``util/parsers.py``.
- ``stale-waiver``        — a ``sweedlint: ok`` comment naming a rule
  that no longer fires on the line it covers (waiver rot).

Run it as ``python -m seaweedfs_tpu_torch.analysis``.  A finding is waived with
an inline comment on the offending line (or the line above)::

    # sweedlint: ok <rule> <reason>

The reason is mandatory: a suppression with no reason does not count and
the violation stands, so every waiver in the tree is self-documenting.
The stale-waiver audit closes the other half of that contract: a waiver
whose rule stopped firing is itself a finding, so the exception list
can only describe code that still needs excepting.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Iterable, Optional

__all__ = [
    "Violation",
    "analyze_file",
    "analyze_paths",
    "baseline_diff",
    "load_baseline",
    "waiver_inventory",
]

_SUPPRESS_RE = re.compile(
    r"#\s*sweedlint:\s*ok\s+(?P<rule>[a-z][a-z-]*)\s+(?P<reason>\S.*)"
)


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str

    @property
    def key(self) -> str:
        """Stable identity used by the baseline file."""
        return f"{self.rule} {self.path}:{self.line}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _suppressed_lines(src_lines: list[str]) -> dict[int, set[str]]:
    """1-based line → rules waived there.  A suppression comment covers its
    own line and the line below it, so both inline and comment-above
    placement work.  ``# sweedlint: ok`` without a rule+reason matches
    nothing — the violation stands."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(src_lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rule = m.group("rule")
        out.setdefault(i, set()).add(rule)
        out.setdefault(i + 1, set()).add(rule)
    return out


def _audit_waivers(
    parsed: list[tuple[str, ast.AST, list[str]]],
    fired: set[tuple[str, str, int]],
) -> list[Violation]:
    """stale-waiver: every ``sweedlint: ok <rule>`` comment must have a
    live ``<rule>`` finding on the line it covers (its own or the next).

    Two rounds so that stale-waiver findings are themselves waivable:
    round one audits waivers naming ordinary rules; round two audits
    waivers naming ``stale-waiver`` against round one's output (a
    comment waiving ``stale-waiver`` with nothing stale beneath it is
    itself rot).
    """
    comments: list[tuple[str, int, str]] = []
    for rel, _tree, src_lines in parsed:
        for i, text in enumerate(src_lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                comments.append((rel, i, m.group("rule")))

    def live(rel: str, i: int, rule: str, in_: set) -> bool:
        return (rel, rule, i) in in_ or (rel, rule, i + 1) in in_

    out: list[Violation] = []
    for rel, i, rule in comments:
        if rule != "stale-waiver" and not live(rel, i, rule, fired):
            out.append(
                Violation(
                    "stale-waiver",
                    rel,
                    i,
                    f"waiver names '{rule}' but no {rule} finding fires on "
                    "this line or the next — the code was fixed or the "
                    "comment drifted; delete it",
                )
            )
    fired2 = fired | {(v.path, v.rule, v.line) for v in out}
    for rel, i, rule in comments:
        if rule == "stale-waiver" and not live(rel, i, rule, fired2):
            out.append(
                Violation(
                    "stale-waiver",
                    rel,
                    i,
                    "waiver names 'stale-waiver' but nothing stale is "
                    "waived on this line or the next; delete it",
                )
            )
    return out


def _scan(
    file_entries: list[tuple[str, str]]
) -> tuple[list[tuple[str, ast.AST, list[str]]], list[Violation]]:
    """Parse + run every rule, pre-audit and pre-suppression: the raw
    finding set a waiver's liveness is judged against."""
    from . import rules as _rules
    from .callgraph import Project

    project = Project()
    parsed: list[tuple[str, ast.AST, list[str]]] = []
    found: list[Violation] = []
    for full, rel in file_entries:
        with open(full, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=full)
        except SyntaxError as e:
            found.append(Violation("parse-error", rel, e.lineno or 0, str(e.msg)))
            continue
        src_lines = src.splitlines()
        project.add_module(rel, tree, src_lines)
        parsed.append((rel, tree, src_lines))

    for rel, tree, _src_lines in parsed:
        for rule in _rules.RULES:
            if not rule.applies_to(rel):
                continue
            found.extend(rule.check(tree, rel))

    if parsed:
        from . import lockgraph as _lockgraph
        from . import racecheck as _racecheck
        from . import taint as _taint

        builder = _lockgraph.LockGraphBuilder(project)
        found.extend(builder.violations())
        found.extend(_taint.check_project(project))
        found.extend(_racecheck.check_project(project, builder))
    return parsed, found


def _analyze(
    file_entries: list[tuple[str, str]], audit_waivers: bool
) -> list[Violation]:
    """Shared engine: per-file rules on each module, then the
    interprocedural rules over the project they jointly form, then the
    waiver audit, then suppression filtering — in that order, because a
    waiver must be able to silence an interprocedural finding and the
    audit must see pre-suppression results."""
    parsed, found = _scan(file_entries)

    if audit_waivers:
        fired = {(v.path, v.rule, v.line) for v in found}
        found.extend(_audit_waivers(parsed, fired))

    waived = {rel: _suppressed_lines(sl) for rel, _t, sl in parsed}
    kept = [
        v
        for v in found
        if v.rule not in waived.get(v.path, {}).get(v.line, ())
    ]
    return sorted(kept, key=lambda v: (v.path, v.line, v.rule))


def analyze_file(
    path: str,
    relpath: Optional[str] = None,
    audit_waivers: bool = False,
) -> list[Violation]:
    """All un-suppressed violations in one source file (the file is its
    own single-module project for the interprocedural rules).  The waiver
    audit is off by default here — a lone file is routinely analyzed out
    of context, where "rule doesn't fire" proves nothing."""
    rel = (relpath or path).replace(os.sep, "/")
    return _analyze([(path, rel)], audit_waivers)


def _iter_py_files(root: str) -> Iterable[tuple[str, str]]:
    if os.path.isfile(root):
        yield root, os.path.basename(root)
        return
    base = os.path.dirname(os.path.abspath(root))
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d not in ("__pycache__", ".git")
        )
        for name in sorted(filenames):
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                yield full, os.path.relpath(full, base)


def analyze_paths(
    paths: Iterable[str], audit_waivers: bool = True
) -> list[Violation]:
    entries: list[tuple[str, str]] = []
    for root in paths:
        for full, rel in _iter_py_files(root):
            entries.append((full, rel.replace(os.sep, "/")))
    return _analyze(entries, audit_waivers)


def waiver_inventory(paths: Iterable[str]) -> list[dict]:
    """Every ``sweedlint: ok`` comment under ``paths`` with its audited
    liveness — the ``--waivers`` CLI mode.  Each entry is ``{"path",
    "line", "rule", "reason", "status"}`` where status is ``"LIVE"``
    (the named rule still fires on a covered line: the waiver earns its
    keep) or ``"STALE"`` (the code was fixed or the comment drifted;
    delete it).  Liveness is the same two-round judgment the gate's
    stale-waiver rule applies, so ``--waivers`` never disagrees with
    the gate about which comments are dead."""
    entries: list[tuple[str, str]] = []
    for root in paths:
        for full, rel in _iter_py_files(root):
            entries.append((full, rel.replace(os.sep, "/")))
    parsed, found = _scan(entries)
    fired = {(v.path, v.rule, v.line) for v in found}
    # the gate filters audit findings through the suppression map too
    # (a waiver naming stale-waiver can cover a dead waiver below it),
    # so liveness here must apply the same filter or the two disagree
    waived = {rel: _suppressed_lines(sl) for rel, _t, sl in parsed}
    stale_at = {
        (v.path, v.line)
        for v in _audit_waivers(parsed, fired)
        if v.rule not in waived.get(v.path, {}).get(v.line, ())
    }
    out: list[dict] = []
    for rel, _tree, src_lines in parsed:
        for i, text in enumerate(src_lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            out.append(
                {
                    "path": rel,
                    "line": i,
                    "rule": m.group("rule"),
                    "reason": m.group("reason").strip(),
                    "status": "STALE" if (rel, i) in stale_at else "LIVE",
                }
            )
    return sorted(out, key=lambda w: (w["path"], w["line"], w["rule"]))


# -- baseline -----------------------------------------------------------------
# The baseline is a checked-in JSON list of violation keys that are known
# and tolerated.  The tier-1 gate fails on any violation NOT in the
# baseline (a regression) and on any baseline entry that no longer fires
# (a stale waiver) — so the baseline can only shrink over time.


def load_baseline(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, list) or not all(
        isinstance(e, str) for e in data
    ):
        raise ValueError(f"baseline {path!r} must be a JSON list of strings")
    return data


def baseline_diff(
    violations: list[Violation], baseline: list[str]
) -> tuple[list[Violation], list[str]]:
    """→ (new violations not in the baseline, stale baseline entries)."""
    have = {v.key for v in violations}
    allowed = set(baseline)
    new = [v for v in violations if v.key not in allowed]
    stale = sorted(allowed - have)
    return new, stale
