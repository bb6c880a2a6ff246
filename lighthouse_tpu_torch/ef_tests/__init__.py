"""EF consensus-spec-tests conformance runner.

Walks the `tests/<config>/<fork>/<runner>/<handler>/<suite>/<case>/`
directory layout of `consensus-spec-tests` (ref:
testing/ef_tests/src/handler.rs:10-55) and executes each case against
this implementation.  Two disciplines carried over from the reference:

- **skip-proofing** (ef_tests/Makefile:141-144 check_all_files_accessed):
  every file under an executed case directory must be consumed by its
  handler; unread files are reported as failures, so a format change in
  the vectors can never be silently ignored.
- **declared skips**: handlers/types this client does not implement are
  listed in SKIPPED_HANDLERS and counted, never silently dropped.

The committed mini-corpus under tests/ef_vectors/ (generated by
`python -m lighthouse_tpu_torch.ef_tests.gen_corpus`) exercises the runner
offline today; the real EF tarballs drop into the same root when
network access allows.
"""
from .runner import (  # noqa: F401
    CaseResult, EfTestRunner, SKIPPED_HANDLERS,
)
