"""graftlint CLI for the port — the single static-analysis entry point.

    python -m lighthouse_tpu_torch.tools.lint                 # text report, rc!=0 on findings
    python -m lighthouse_tpu_torch.tools.lint --format json   # machine-readable
    python -m lighthouse_tpu_torch.tools.lint --format sarif  # CI / editor ingestion
    python -m lighthouse_tpu_torch.tools.lint --rules trace-safety,lock-discipline path/
    python -m lighthouse_tpu_torch.tools.lint --changed HEAD~1  # report only files touched vs a ref
    python -m lighthouse_tpu_torch.tools.lint --no-baseline   # raw findings
    python -m lighthouse_tpu_torch.tools.lint --jobs 4 --no-cache  # per-file stage tuning
    python -m lighthouse_tpu_torch.tools.lint --shared-state  # graftrace model dump (triage)

Scans ``lighthouse_tpu_torch/`` against the port's own baseline
(``lighthouse_tpu_torch/analysis/baseline.json``); the cache lives under
``lighthouse_tpu_torch/_build/``.

Exit codes: 0 clean (baselined findings allowed), 1 non-baselined
violations, 2 usage/baseline-format errors. Pure AST — neither torch
nor the card is touched, so it runs in seconds on any CPU; the
content-hash cache makes warm reruns near-instant.

``--changed REF`` still ANALYZES the full tree (the interprocedural
rules need every module's facts to resolve calls — and the cache makes
that cheap) but REPORTS only findings in files that differ from REF.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from ..analysis import Project, all_rules, load_baseline, run_project
from ..analysis.engine import render_json, render_sarif, render_text

REPO = Path(__file__).resolve().parents[2]
PACKAGE = REPO / "lighthouse_tpu_torch"
DEFAULT_BASELINE = PACKAGE / "analysis" / "baseline.json"
DEFAULT_CACHE = PACKAGE / "_build" / "graftlint.cache"


def _changed_paths(ref: str) -> set[str] | None:
    """Repo-relative paths that differ from ``ref`` (tracked diff +
    untracked files), or None if git is unavailable."""
    out: set[str] = set()
    try:
        for cmd in (["git", "diff", "--name-only", ref, "--"],
                    ["git", "ls-files", "--others",
                     "--exclude-standard"]):
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=30)
            if proc.returncode != 0:
                print(f"--changed: {' '.join(cmd)} failed: "
                      f"{proc.stderr.strip()}", file=sys.stderr)
                return None
            out.update(line.strip() for line in proc.stdout.splitlines()
                       if line.strip())
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"--changed: git unavailable: {e}", file=sys.stderr)
        return None
    return out


def _dump_shared_state(paths: list[Path]) -> int:
    """Triage view for the data-race rule: every modeled class with its
    seeding, entry methods, and per-attribute lockset verdict."""
    from ..analysis.callgraph import CallGraph, build_facts
    from ..analysis.sharedstate import build_model, classify_attrs, \
        scan_module
    project = Project.load(REPO, paths)
    data, facts = {}, {}
    for m in project.modules:
        facts[m.relpath] = build_facts(m.tree, m.relpath)
        scan = scan_module(m.tree, m.relpath)
        if scan is not None:
            data[m.relpath] = scan
    model = build_model(data, CallGraph(facts))
    for (rel, cls), sc in sorted(model.items()):
        seeds = ", ".join(sorted(sc.seeded_by)) or "lock-owning only"
        print(f"{rel}:{sc.line} {cls}  [{seeds}]")
        if sc.entry_methods:
            print(f"  entry: {', '.join(sorted(sc.entry_methods))}")
        for attr, rep in sorted(classify_attrs(sc).items()):
            guard = f" under {'+'.join(rep.guard)}" if rep.guard else ""
            print(f"  {attr}: {rep.status}{guard}")
    print(f"-- {len(model)} shared class(es)")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*", type=Path,
                    default=None, help="files/dirs to scan "
                    "(default: lighthouse_tpu_torch/)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule names (default: all)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the allowlist, report everything")
    ap.add_argument("--changed", metavar="REF", default=None,
                    help="report only findings in files that differ "
                    "from this git ref (full tree is still analyzed)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes for the per-file stage "
                    "(default: serial; the cache usually wins on reruns)")
    ap.add_argument("--cache", type=Path, default=DEFAULT_CACHE,
                    help=f"per-file analysis cache (default: "
                    f"{DEFAULT_CACHE.relative_to(REPO)})")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-hash cache")
    ap.add_argument("--shared-state", action="store_true",
                    help="print the graftrace shared-state model "
                    "(classes, spawn seeds, per-attr lockset verdicts) "
                    "instead of a violation report")
    args = ap.parse_args(argv)

    if args.shared_state:
        return _dump_shared_state(args.paths or [PACKAGE])

    rules = all_rules()
    if args.rules:
        wanted = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in wanted if r not in rules]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(have: {', '.join(sorted(rules))})", file=sys.stderr)
            return 2
        rules = {k: v for k, v in rules.items() if k in wanted}

    try:
        baseline = [] if args.no_baseline else load_baseline(args.baseline)
    except (ValueError, OSError) as e:
        print(f"baseline error: {e}", file=sys.stderr)
        return 2

    changed: set[str] | None = None
    if args.changed is not None:
        git_paths = _changed_paths(args.changed)
        if git_paths is None:
            return 2
        # violation paths are relative to the scan root's parent
        changed = set()
        for p in git_paths:
            try:
                changed.add(str((REPO / p).resolve()
                                .relative_to(REPO.parent)))
            except ValueError:
                continue

    paths = args.paths or [PACKAGE]
    project = Project.load(REPO, paths)
    report = run_project(
        project, rules, baseline, jobs=args.jobs,
        cache_path=None if args.no_cache else args.cache)
    if changed is not None:
        report["violations"] = [v for v in report["violations"]
                                if v.path in changed]
        report["baselined"] = [v for v in report["baselined"]
                               if v.path in changed]
        # a baseline entry for an untouched file is not stale just
        # because this invocation filtered its file out
        report["stale_baseline"] = []
    if args.format == "json":
        out = render_json(report)
    elif args.format == "sarif":
        out = render_sarif(report, {n: r.description
                                    for n, r in all_rules().items()})
    else:
        out = render_text(report)
    try:
        print(out)
    except BrokenPipeError:
        pass                         # | head etc. closed the pipe
    return 1 if report["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
