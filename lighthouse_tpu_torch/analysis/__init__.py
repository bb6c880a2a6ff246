"""graftlint — project-native static analysis of the PyTorch/CUDA port.

Mechanical enforcement of the invariants the device paths and the
concurrent service layer depend on ("Security Review of Ethereum Beacon
Clients", PAPERS.md): accounted host readbacks, build-once kernel
libraries, roofline-tracked kernel entries and sync-free device
programs for the CUDA kernels, lock/thread discipline for the
beacon/network machinery, and drift-freedom for spec constants and SSZ
schemas.

Entry points:
- ``python -m lighthouse_tpu_torch.tools.lint`` — the CLI (text/JSON/SARIF
  reports, baseline; ``--shared-state`` dumps the graftrace concurrency
  model for triage).
- :func:`lighthouse_tpu_torch.analysis.engine.run_project` — library API.
- :mod:`.locksan` — the runtime lock sanitizer built from the same
  shared-state model (``install_lock_tracking`` then ``arm_repo``).

Rules live in :mod:`lighthouse_tpu_torch.analysis.rules`; the ten host
rules are the JAX package's, documented in ANALYSIS.md, and the four
device rules read the port's own idiom. Their seeded fixtures are in
``fixtures/`` (the device rules) and ``tests/lint_fixtures/`` (the host
rules). The suite is pure AST (it imports neither torch nor the card's
toolchain), so it runs in seconds on a CPU.
"""
from .engine import (  # noqa: F401
    Project, Rule, Violation, all_rules, load_baseline, run_project,
)
from . import rules  # noqa: F401  (imports register every rule)
