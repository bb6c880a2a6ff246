"""Run the port's EF conformance walker (``ef_tests/``) over the committed
mini-corpus.

The cases of the JAX package's tests/test_ef_vectors.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, the
``python`` backend pinned as the reference pins it, the backend put back
after each test). Beside them: the port's corpus generator writes the BLS
cases byte for byte as the JAX package's does, and the aggregation cases
give the same answers on the port's ``gpu`` backend (its aggregation runs
on the C++ host library) as on both packages' ``python`` backends.
"""
from pathlib import Path

import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.ef_tests import EfTestRunner

CORPUS = Path(__file__).parent / "ef_vectors" / "tests"


@pytest.fixture(autouse=True)
def real_crypto():
    # conformance must run with REAL crypto, never the fake backend
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("python")
    yield
    bls._current = saved
    set_device(prev)


def test_corpus_exists_and_is_big_enough():
    assert CORPUS.is_dir(), \
        "run python -m lighthouse_tpu_torch.ef_tests.gen_corpus"
    n_cases = sum(1 for p in CORPUS.rglob("*")
                  if p.is_dir() and (list(p.glob("*.yaml"))
                                     or list(p.glob("*.ssz_snappy"))))
    assert n_cases >= 80, f"only {n_cases} vector cases committed"


def test_all_vectors_pass_with_no_skipped_files():
    results = EfTestRunner(CORPUS).run()
    ran = [r for r in results if not r.skipped]
    failed = [r for r in ran if not r.ok]
    assert not failed, "\n".join(f"{r.path}: {r.error}" for r in failed)
    # the mini-corpus must exercise every implemented runner
    runners = {r.path.split("/")[2] for r in ran}
    assert {"ssz_static", "operations", "epoch_processing", "sanity",
            "bls", "fork_choice"} <= runners
    assert len(ran) >= 80
    # OUR corpus must exercise only implemented handlers: no skips at all
    skipped = [r for r in results if r.skipped]
    assert not skipped, "\n".join(f"{r.path}: {r.error}" for r in skipped)


def test_walker_reports_unconsumed_files(tmp_path):
    """Skip-proofing: an extra file in a case dir fails that case."""
    import shutil
    src = next((CORPUS / "minimal" / "altair" / "ssz_static").rglob(
        "case_0"))
    dst = tmp_path / "tests" / "minimal" / "altair" / "ssz_static" / \
        src.parent.parent.name / "ssz_random" / "case_0"
    shutil.copytree(src, dst)
    (dst / "surprise.yaml").write_text("x: 1")
    results = EfTestRunner(tmp_path / "tests").run()
    assert any(not r.ok and "not consumed" in r.error for r in results)


def test_bls_generator_writes_the_jax_packages_files(tmp_path):
    """``gen_corpus.gen_bls`` of both packages (signed on each package's
    C++ backend) into two directories: the same files, byte for byte."""
    from lighthouse_tpu.ef_tests import gen_corpus as j_gen_corpus
    from lighthouse_tpu_torch.ef_tests import gen_corpus
    n = gen_corpus.gen_bls(tmp_path / "port")
    assert n == j_gen_corpus.gen_bls(tmp_path / "jax") > 0

    def files(root):
        return {p.relative_to(root): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}

    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert len(got) == n
    assert got == want


def _aggregation_cases():
    return sorted(p for handler in ("phase0/bls/aggregate",
                                    "altair/bls/eth_aggregate_pubkeys")
                  for p in (CORPUS / "general" / handler).rglob("data.yaml"))


def test_aggregation_cases_agree_on_gpu_and_python():
    """Every ``aggregate`` and ``eth_aggregate_pubkeys`` case of the corpus
    through the port's ``gpu`` backend (its aggregation on the C++ host
    library, no card needed) gives what both packages' ``python``
    backends give."""
    import yaml

    from lighthouse_tpu.crypto import bls as jbls
    from lighthouse_tpu_torch.crypto.bls.gpu_backend import GpuBackend
    cases = _aggregation_cases()
    assert len(cases) >= 3
    backends = (GpuBackend(), bls._make("python"), jbls.PythonBackend())

    def answer(backend, handler, inp):
        raw = [bytes.fromhex(x[2:]) for x in inp]
        try:
            if handler == "aggregate":
                return backend.aggregate_signatures(raw)
            return backend.aggregate_public_keys(raw)
        except ValueError:
            return "invalid"

    for path in cases:
        data = yaml.safe_load(path.read_text())
        handler = path.parts[-4]
        got = [answer(b, handler, data["input"]) for b in backends]
        assert got[0] == got[1] == got[2], path
