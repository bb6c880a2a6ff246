"""data-race: shared attributes accessed with inconsistent locksets.

graftrace's reporting rule, built on the v3 shared-state model
(``analysis/sharedstate.py``).  A class is *shared* when one of its
bound methods crosses a thread boundary — resolved through the shared
call graph from every ``spawn``/``submit``/``Thread(target=...)``/
``Work(run=...)``/``add_listener`` site — or when it self-declares
concurrency by owning a lock.  For each shared class the per-method
lockset dataflow annotates every ``self.<attr>`` access with the set of
locks held (``with self._lock:`` nesting, plus locksets *inherited* by
private helpers only ever called with a lock held), then the lattice
walk classifies each attribute:

- **write-no-lock** — the attribute has guarded accesses (or is provably
  multi-thread via a spawn seed) yet some write happens with no lock:
  guarded readers can observe the torn update.
- **lock-mix** — every write is guarded, but by *different* locks: two
  writers holding different locks do not exclude each other.
- **check-then-act** — an unlocked ``if`` reads the attribute and the
  branch writes it: two threads can both pass the test (the classic
  lost-update / double-start TOCTOU).  The double-checked pattern
  (locked re-test inside the branch) is exempt.

Safe shapes that never fire (the "safe-publish" half of the lattice):
init-only writes, literal ``True``/``False`` flag publishes, attributes
bound to internally-synchronized objects (locks, events, queues), and
attributes with one consistent guard everywhere.  Unlocked *reads*
alone are also exempt — a bare read is an atomic GIL snapshot; it only
matters when it feeds a write decision.

Every static finding here is cross-checkable at runtime: the lock
sanitizer (``analysis/locksan.py``, pytest ``--sanitize-locks``) arms
the same model's *guarded* verdicts and reports any access that
violates them under a real interleaving.
"""
from __future__ import annotations

from ..engine import Module, Project, Rule, Violation, rule
from ..sharedstate import build_model, classify_attrs, scan_module


@rule
class DataRaceRule(Rule):
    name = "data-race"
    description = ("shared class attributes accessed with inconsistent "
                   "locksets: write-without-lock, lock-mix, and "
                   "check-then-act on fields that cross thread "
                   "boundaries")

    # -- per-file (cached) stage ---------------------------------------------

    def summarize_module(self, module: Module, project: Project):
        return scan_module(module.tree, module.relpath)

    # -- cross-file stage ----------------------------------------------------

    def finalize_project(self, ctx) -> list:
        model = build_model(ctx.data_for(self.name), ctx.graph)
        out = []
        for (rel, cls_qual), sc in sorted(model.items()):
            for attr, rep in classify_attrs(sc).items():
                for category, method, line, message in rep.findings:
                    out.append(Violation(
                        rule=self.name, path=rel, line=line,
                        message=f"[{category}] {message}",
                        symbol=f"{cls_qual}.{method}"))
        return out
