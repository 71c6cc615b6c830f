"""CLI: ``python -m seaweedfs_tpu_torch.analysis [paths...] [options]``.

Exit status 0 = clean (no violations beyond the baseline, no stale
baseline entries), 1 = findings, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import (
    _analyze,
    analyze_paths,
    baseline_diff,
    load_baseline,
    waiver_inventory,
)

_SARIF_VERSION = "2.1.0"
_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _changed_files(repo_root: str, base: str) -> list[str]:
    """Repo-relative ``*.py`` paths that differ from ``merge-base(HEAD,
    base)`` — plus uncommitted edits.  ``base='auto'`` prefers
    ``origin/main``, then ``main``, then plain HEAD (working-tree diff
    only)."""
    candidates = [base] if base != "auto" else ["origin/main", "main"]
    merge_base = "HEAD"
    for ref in candidates:
        r = subprocess.run(
            ["git", "merge-base", "HEAD", ref],
            cwd=repo_root,
            capture_output=True,
            text=True,
        )
        if r.returncode == 0:
            merge_base = r.stdout.strip()
            break
    r = subprocess.run(
        ["git", "diff", "--name-only", merge_base, "--", "*.py"],
        cwd=repo_root,
        capture_output=True,
        text=True,
    )
    if r.returncode != 0:
        raise SystemExit(f"git diff failed: {r.stderr.strip()}")
    out = []
    for rel in r.stdout.splitlines():
        rel = rel.strip()
        # only package code is a lint target (tests and fixtures contain
        # deliberate violations and waiver text inside string literals)
        if not rel.startswith("seaweedfs_tpu_torch/"):
            continue
        if rel and os.path.exists(os.path.join(repo_root, rel)):
            out.append(rel)
    return sorted(set(out))


def _to_sarif(violations) -> dict:
    rule_ids = sorted({v.rule for v in violations})
    return {
        "$schema": _SARIF_SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "sweedlint",
                        "informationUri": "docs/ANALYSIS.md",
                        "rules": [{"id": r} for r in rule_ids],
                    }
                },
                "results": [
                    {
                        "ruleId": v.rule,
                        "level": "error",
                        "message": {"text": v.message},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {"uri": v.path},
                                    "region": {"startLine": max(v.line, 1)},
                                }
                            }
                        ],
                    }
                    for v in violations
                ],
            }
        ],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m seaweedfs_tpu_torch.analysis",
        description="sweedlint: project-specific static analysis",
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files or directories to scan (default: the "
        "seaweedfs_tpu_torch package itself)",
    )
    p.add_argument(
        "--baseline",
        metavar="FILE",
        help="JSON list of tolerated violation keys; new violations and "
        "stale entries both fail",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.add_argument(
        "--sarif",
        action="store_true",
        help="SARIF 2.1.0 output (code-scanning upload format)",
    )
    p.add_argument(
        "--sarif-out",
        metavar="FILE",
        help="also write the SARIF 2.1.0 document to FILE (the CI "
        "artifact path), independent of the stdout format",
    )
    p.add_argument(
        "--waivers",
        action="store_true",
        help="audit mode: list every 'sweedlint: ok' comment with its "
        "liveness (LIVE = the named rule still fires on a covered "
        "line, STALE = delete it); exit 1 if anything is stale",
    )
    p.add_argument(
        "--keys",
        action="store_true",
        help="print violation keys only (paste into a baseline file)",
    )
    p.add_argument(
        "--changed",
        nargs="?",
        const="auto",
        metavar="BASE",
        help="lint only files differing from git merge-base(HEAD, BASE) "
        "plus uncommitted edits (default BASE: origin/main, then main). "
        "Fast pre-commit loop: the interprocedural rules see only the "
        "changed subset — the tier-1 gate remains authoritative",
    )
    args = p.parse_args(argv)
    if args.changed and args.paths:
        p.error("--changed and explicit paths are mutually exclusive")
    if args.waivers and args.changed:
        p.error(
            "--waivers needs the whole project: on a partial file set "
            "the interprocedural rules cannot fire, so every waiver "
            "they justify would misreport as stale"
        )

    if args.waivers:
        paths = args.paths or [os.path.dirname(os.path.dirname(__file__))]
        inv = waiver_inventory(paths)
        if args.json:
            print(json.dumps({"waivers": inv}, indent=1))
        else:
            for w in inv:
                print(
                    f"{w['status']:5} [{w['rule']}] "
                    f"{w['path']}:{w['line']}  {w['reason']}"
                )
            stale_n = sum(1 for w in inv if w["status"] == "STALE")
            print(
                f"sweedlint: {len(inv)} waiver(s), {stale_n} stale"
            )
        return 1 if any(w["status"] == "STALE" for w in inv) else 0

    if args.changed:
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        repo_root = os.path.dirname(pkg_dir)
        rels = _changed_files(repo_root, args.changed)
        entries = [(os.path.join(repo_root, rel), rel) for rel in rels]
        # no waiver audit on a partial file set: the interprocedural rules
        # can't fire without the rest of the project, so their waivers
        # would all read as stale
        violations = _analyze(entries, audit_waivers=False)
    else:
        paths = args.paths or [os.path.dirname(os.path.dirname(__file__))]
        violations = analyze_paths(paths)
    baseline = load_baseline(args.baseline) if args.baseline else []
    new, stale = baseline_diff(violations, baseline)

    if args.sarif_out:
        doc = _to_sarif(new)
        out_dir = os.path.dirname(os.path.abspath(args.sarif_out))
        os.makedirs(out_dir, exist_ok=True)
        tmp = args.sarif_out + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, args.sarif_out)

    if args.sarif:
        print(json.dumps(_to_sarif(new), indent=1))
    elif args.json:
        print(
            json.dumps(
                {
                    "violations": [v.__dict__ for v in new],
                    "stale_baseline": stale,
                },
                indent=1,
            )
        )
    elif args.keys:
        for v in new:
            print(v.key)
    else:
        for v in new:
            print(v)
        for key in stale:
            print(f"stale baseline entry (no longer fires): {key}")
        n, s = len(new), len(stale)
        if n or s:
            print(f"sweedlint: {n} violation(s), {s} stale baseline entr(ies)")
        else:
            print(f"sweedlint: clean ({len(violations)} baselined)")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
