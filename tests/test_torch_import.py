"""The port stands alone: importing any of its modules (and chip_smoke.py)
loads neither jax nor the JAX package, and the default device is the card
unless a caller switches it explicitly."""
import os
import subprocess
import sys

import pytest
import torch

from lighthouse_tpu_torch import device
from lighthouse_tpu_torch.ops.merkle_tree import DeviceTree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import lighthouse_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "lighthouse_tpu" or m.startswith("lighthouse_tpu."))
need = {"lighthouse_tpu_torch.ops.bigint", "lighthouse_tpu_torch.ops.bls12_381",
        "lighthouse_tpu_torch.ops.bls_consts", "lighthouse_tpu_torch.bls_batch",
        "lighthouse_tpu_torch.crypto.bls", "lighthouse_tpu_torch.crypto.bls.gpu_backend",
        "lighthouse_tpu_torch.crypto.bls.cpp_backend",
        "lighthouse_tpu_torch.crypto.bls12_381.sig",
        "lighthouse_tpu_torch.entry", "lighthouse_tpu_torch.measure",
        "lighthouse_tpu_torch.parallel", "lighthouse_tpu_torch.parallel.mesh",
        "lighthouse_tpu_torch.parallel.launch",
        "lighthouse_tpu_torch.parallel.merkle",
        "lighthouse_tpu_torch.parallel.bls",
        "lighthouse_tpu_torch.state_transition",
        "lighthouse_tpu_torch.state_transition.block",
        "lighthouse_tpu_torch.state_transition.block_replayer",
        "lighthouse_tpu_torch.state_transition.epoch",
        "lighthouse_tpu_torch.state_transition.genesis",
        "lighthouse_tpu_torch.state_transition.helpers",
        "lighthouse_tpu_torch.state_transition.shuffle",
        "lighthouse_tpu_torch.state_transition.signature_sets",
        "lighthouse_tpu_torch.state_transition.slot",
        "lighthouse_tpu_torch.state_transition.upgrades",
        "lighthouse_tpu_torch.utils.native_hash", "lighthouse_tpu_torch.utils.gxx",
        "lighthouse_tpu_torch.ssz.merkle_proof",
        "lighthouse_tpu_torch.testing.state_harness",
        "lighthouse_tpu_torch.stf_workload",
        "lighthouse_tpu_torch.api.metrics", "lighthouse_tpu_torch.api.metrics_defs",
        "lighthouse_tpu_torch.utils.log_buffer",
        "lighthouse_tpu_torch.utils.system_health",
        "lighthouse_tpu_torch.obs", "lighthouse_tpu_torch.obs.tracing",
        "lighthouse_tpu_torch.obs.occupancy", "lighthouse_tpu_torch.obs.timeseries",
        "lighthouse_tpu_torch.obs.cuda_accounting",
        "lighthouse_tpu_torch.obs.roofline", "lighthouse_tpu_torch.obs.device",
        "lighthouse_tpu_torch.obs.slo", "lighthouse_tpu_torch.obs.critpath",
        "lighthouse_tpu_torch.obs.causal", "lighthouse_tpu_torch.obs.flight",
        "lighthouse_tpu_torch.obs.capture", "lighthouse_tpu_torch.obs.report",
        "lighthouse_tpu_torch.obs.doctor", "lighthouse_tpu_torch.obs.graftwatch",
        "lighthouse_tpu_torch.utils.slot_clock",
        "lighthouse_tpu_torch.utils.crashpoints",
        "lighthouse_tpu_torch.utils.threads",
        "lighthouse_tpu_torch.fork_choice",
        "lighthouse_tpu_torch.fork_choice.proto_array",
        "lighthouse_tpu_torch.fork_choice.fork_choice",
        "lighthouse_tpu_torch.operation_pool",
        "lighthouse_tpu_torch.operation_pool.max_cover",
        "lighthouse_tpu_torch.operation_pool.pool",
        "lighthouse_tpu_torch.store", "lighthouse_tpu_torch.store.kv",
        "lighthouse_tpu_torch.store.chunked_vector",
        "lighthouse_tpu_torch.store.schema_change",
        "lighthouse_tpu_torch.store.hot_cold",
        "lighthouse_tpu_torch.store.fsck",
        "lighthouse_tpu_torch.beacon_processor",
        "lighthouse_tpu_torch.beacon_processor.processor",
        "lighthouse_tpu_torch.beacon_processor.reprocess",
        "lighthouse_tpu_torch.chain", "lighthouse_tpu_torch.chain.errors",
        "lighthouse_tpu_torch.chain.events",
        "lighthouse_tpu_torch.chain.execution",
        "lighthouse_tpu_torch.chain.observed",
        "lighthouse_tpu_torch.chain.block_times_cache",
        "lighthouse_tpu_torch.chain.hot_caches",
        "lighthouse_tpu_torch.chain.attestation_verification",
        "lighthouse_tpu_torch.chain.block_verification",
        "lighthouse_tpu_torch.chain.sync_committee",
        "lighthouse_tpu_torch.chain.light_client",
        "lighthouse_tpu_torch.chain.data_availability",
        "lighthouse_tpu_torch.chain.data_columns",
        "lighthouse_tpu_torch.chain.validator_monitor",
        "lighthouse_tpu_torch.chain.persistence",
        "lighthouse_tpu_torch.chain.beacon_chain",
        "lighthouse_tpu_torch.chain.builder",
        "lighthouse_tpu_torch.chain.harness",
        "lighthouse_tpu_torch.chain.replay",
        "lighthouse_tpu_torch.chain.replay.engine",
        "lighthouse_tpu_torch.network", "lighthouse_tpu_torch.network.secp256k1",
        "lighthouse_tpu_torch.network.multistream",
        "lighthouse_tpu_torch.network.noise_xx",
        "lighthouse_tpu_torch.network.plaintext",
        "lighthouse_tpu_torch.network.yamux",
        "lighthouse_tpu_torch.network.gossipsub_pb",
        "lighthouse_tpu_torch.network.snappy",
        "lighthouse_tpu_torch.network.transport",
        "lighthouse_tpu_torch.network.gossip", "lighthouse_tpu_torch.network.rpc",
        "lighthouse_tpu_torch.network.peer_manager",
        "lighthouse_tpu_torch.network.service",
        "lighthouse_tpu_torch.network.sync",
        "lighthouse_tpu_torch.network.sync.batches",
        "lighthouse_tpu_torch.network.sync.validation",
        "lighthouse_tpu_torch.network.sync.backfill",
        "lighthouse_tpu_torch.network.sync.lookups",
        "lighthouse_tpu_torch.network.sync.range_sync",
        "lighthouse_tpu_torch.network.sync.manager",
        "lighthouse_tpu_torch.network.keccak", "lighthouse_tpu_torch.network.rlp",
        "lighthouse_tpu_torch.network.enr",
        "lighthouse_tpu_torch.network.discv5_wire",
        "lighthouse_tpu_torch.network.discv5",
        "lighthouse_tpu_torch.network.persisted_dht",
        "lighthouse_tpu_torch.network.discovery",
        "lighthouse_tpu_torch.network.nat", "lighthouse_tpu_torch.network.faults",
        "lighthouse_tpu_torch.specs.networks",
        "lighthouse_tpu_torch.utils.monitoring",
        "lighthouse_tpu_torch.crypto.key_derivation",
        "lighthouse_tpu_torch.crypto.keystore",
        "lighthouse_tpu_torch.crypto.wallet",
        "lighthouse_tpu_torch.api", "lighthouse_tpu_torch.api.json_repr",
        "lighthouse_tpu_torch.api.serving",
        "lighthouse_tpu_torch.api.serving.cache",
        "lighthouse_tpu_torch.api.serving.coalesce",
        "lighthouse_tpu_torch.api.serving.shed",
        "lighthouse_tpu_torch.api.serving.tier",
        "lighthouse_tpu_torch.api.backend",
        "lighthouse_tpu_torch.api.http_server",
        "lighthouse_tpu_torch.validator_client",
        "lighthouse_tpu_torch.validator_client.slashing_protection",
        "lighthouse_tpu_torch.validator_client.validator_store",
        "lighthouse_tpu_torch.validator_client.fallback",
        "lighthouse_tpu_torch.validator_client.client",
        "lighthouse_tpu_torch.validator_client.http_client",
        "lighthouse_tpu_torch.validator_client.keymanager",
        "lighthouse_tpu_torch.validator_client.remote_signer",
        "lighthouse_tpu_torch.validator_client.byzantine",
        "lighthouse_tpu_torch.validator_manager",
        "lighthouse_tpu_torch.testing.fuzz",
        "lighthouse_tpu_torch.__main__", "lighthouse_tpu_torch.client",
        "lighthouse_tpu_torch.client.builder",
        "lighthouse_tpu_torch.client.environment",
        "lighthouse_tpu_torch.watch", "lighthouse_tpu_torch.watch.monitor",
        "lighthouse_tpu_torch.testing.simulator",
        "lighthouse_tpu_torch.testing.scenarios",
        "lighthouse_tpu_torch.ef_tests", "lighthouse_tpu_torch.ef_tests.runner",
        "lighthouse_tpu_torch.ef_tests.scalar_spec",
        "lighthouse_tpu_torch.ef_tests.scalar_spec_electra",
        "lighthouse_tpu_torch.ef_tests.gen_corpus",
        "lighthouse_tpu_torch.ef_tests.gen_corpus_r3",
        "lighthouse_tpu_torch.ef_tests.gen_corpus_r5",
        "lighthouse_tpu_torch.analysis", "lighthouse_tpu_torch.analysis.engine",
        "lighthouse_tpu_torch.analysis.cache",
        "lighthouse_tpu_torch.analysis.callgraph",
        "lighthouse_tpu_torch.analysis.sharedstate",
        "lighthouse_tpu_torch.analysis.locksan",
        "lighthouse_tpu_torch.analysis.rules",
        "lighthouse_tpu_torch.analysis.rules.compile_budget",
        "lighthouse_tpu_torch.analysis.rules.cow_discipline",
        "lighthouse_tpu_torch.analysis.rules.data_race",
        "lighthouse_tpu_torch.analysis.rules.device_transfer",
        "lighthouse_tpu_torch.analysis.rules.lock_discipline",
        "lighthouse_tpu_torch.analysis.rules.lock_order",
        "lighthouse_tpu_torch.analysis.rules.recompilation",
        "lighthouse_tpu_torch.analysis.rules.serving_cache_discipline",
        "lighthouse_tpu_torch.analysis.rules.shutdown_order",
        "lighthouse_tpu_torch.analysis.rules.spec_constants",
        "lighthouse_tpu_torch.analysis.rules.ssz_schema",
        "lighthouse_tpu_torch.analysis.rules.store_atomicity",
        "lighthouse_tpu_torch.analysis.rules.thread_lifecycle",
        "lighthouse_tpu_torch.analysis.rules.trace_safety",
        "lighthouse_tpu_torch.analysis.fixtures",
        "lighthouse_tpu_torch.analysis.fixtures.compile_budget_fix",
        "lighthouse_tpu_torch.analysis.fixtures.device_transfer_fix",
        "lighthouse_tpu_torch.analysis.fixtures.recompile_hazard_fix",
        "lighthouse_tpu_torch.analysis.fixtures.trace_safety_fix",
        "lighthouse_tpu_torch.tools", "lighthouse_tpu_torch.tools.lint",
        "lighthouse_tpu_torch.tools.obs_diff",
        "lighthouse_tpu_torch.tools.obs_doctor",
        "lighthouse_tpu_torch.tools.store_fsck",
        "lighthouse_tpu_torch.tools.trace_report",
        "lighthouse_tpu_torch.tools.perf_model",
        "lighthouse_tpu_torch.tools.gil_throughput",
        "lighthouse_tpu_torch.tools.bls_10k_correctness",
        "lighthouse_tpu_torch.tools.sanitize"}
print(len(names), sorted(need - set(names)), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, rest = out.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert rest == "[] []"


def test_default_device_is_cuda_and_never_falls_back():
    prev = device.set_device("cuda")
    try:
        if torch.cuda.is_available():
            assert device.get_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                device.get_device()
            with pytest.raises(RuntimeError):
                DeviceTree(4, 16)
        device.set_device("cpu")
        assert device.get_device() == torch.device("cpu")
        assert DeviceTree(4, 16).device == torch.device("cpu")
        with pytest.raises(ValueError):
            device.set_device("tpu")
    finally:
        device.set_device(prev)


def test_explicit_device_argument_wins_over_default():
    prev = device.set_device("cpu")
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                DeviceTree(4, 16, device="cuda")
        assert DeviceTree(4, 16, device="cpu").device.type == "cpu"
    finally:
        device.set_device(prev)


def test_bls_backend_needs_the_card_by_default(monkeypatch):
    """The gpu backend, the BLS module's default, runs on the port's
    device: with the default (``cuda``) and no card it raises instead of
    verifying on the CPU, through the backend and the module entry."""
    from lighthouse_tpu_torch.crypto import bls
    from lighthouse_tpu_torch.crypto.bls import SignatureSet
    from lighthouse_tpu_torch.crypto.bls import gpu_backend
    monkeypatch.delenv("LHTPU_BLS_LANES", raising=False)
    prev = device.set_device("cuda")
    try:
        if torch.cuda.is_available():
            assert gpu_backend.lane_options() == (128, 10240)
            return
        with pytest.raises(RuntimeError):
            gpu_backend.lane_options()
        backend = gpu_backend.GpuBackend()
        sig = bytes([0xA0]) + bytes(95)
        pk = bytes([0x97]) + bytes.fromhex(
            "f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
            "6c55e83ff97a1aeffb3af00adb22c6bb")
        with pytest.raises(RuntimeError):
            backend.verify_signature_sets([SignatureSet(sig, [pk], b"m")])
        # the module entry's default backend is gpu: no silent host path
        prev_backend = bls._current
        try:
            bls._current = None
            with pytest.raises(RuntimeError):
                bls.verify_signature_sets([SignatureSet(sig, [pk], b"m")])
        finally:
            bls._current = prev_backend
    finally:
        device.set_device(prev)


def _undefined_names(path: str) -> list[str]:
    """Names a module's code reads that resolve to no binding: not in an
    enclosing function, not at module level, not a builtin (``symtable``
    scopes them as the compiler does)."""
    import builtins
    import symtable

    top = symtable.symtable(open(path).read(), path, "exec")
    defined = {s.get_name() for s in top.get_symbols()
               if s.is_assigned() or s.is_imported() or s.is_namespace()}
    defined |= set(dir(builtins)) | {"__file__", "__name__", "__doc__",
                                     "__spec__", "__path__", "__package__"}
    bad = []

    def walk(table):
        for s in table.get_symbols():
            if (s.is_referenced() and s.is_global()
                    and s.get_name() not in defined):
                bad.append(f"{table.get_name()}: {s.get_name()}")
        for child in table.get_children():
            walk(child)

    walk(top)
    return bad


_PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, "lighthouse_tpu_torch"))
    for f in fs if f.endswith(".py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_port_module_reads_no_undefined_name(rel):
    """Every name a port module's code reads is bound somewhere it can
    see: a helper deleted while its callers stay fails here, also in code
    that only runs on the card."""
    assert _undefined_names(os.path.join(REPO, rel)) == []


def _module_names(path: str) -> set[str] | None:
    """The names a module binds at its top level (under ``if``/``try``
    too), or None where a module-level ``__getattr__`` makes any name
    resolvable."""
    import ast

    tree = ast.parse(open(path).read(), path)
    names: set[str] = set()
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                names |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                stack.extend(getattr(node, field, []))
        elif isinstance(node, ast.ExceptHandler):
            stack.extend(node.body)
    return None if "__getattr__" in names else names


def _unresolved_imports(rel: str) -> list[str]:
    """Every ``from X import y`` of the port, at module level or inside a
    function body, whose X is the port's and names no module file, or
    whose y is neither a submodule of X nor a name X binds."""
    import ast

    path = os.path.join(REPO, rel)
    package = os.path.dirname(rel).split(os.sep) if rel != "chip_smoke.py" \
        else []
    if os.path.basename(rel) == "__init__.py":
        package = os.path.dirname(rel).split(os.sep)
    bad = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level:
            base = package[:len(package) - (node.level - 1)]
            parts = base + (node.module.split(".") if node.module else [])
        elif (node.module or "").split(".")[0] == "lighthouse_tpu_torch":
            parts = node.module.split(".")
        else:
            continue
        where = os.path.join(REPO, *parts)
        init = os.path.join(where, "__init__.py")
        target = init if os.path.isfile(init) else where + ".py"
        if not os.path.isfile(target):
            bad.append(f"line {node.lineno}: no module {'.'.join(parts)}")
            continue
        bound = _module_names(target)
        for alias in node.names:
            if alias.name == "*" or bound is None or alias.name in bound:
                continue
            sub = os.path.join(where, alias.name)
            if not (os.path.isfile(sub + ".py")
                    or os.path.isfile(os.path.join(sub, "__init__.py"))):
                bad.append(f"line {node.lineno}: {'.'.join(parts)} has no "
                           f"{alias.name}")
    return bad


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_port_module_imports_resolve(rel):
    """Every ``from ... import`` of the port's own modules names a module
    in the port and a name that module binds, also the imports made
    lazily inside a function body, which loading the module never runs."""
    assert _unresolved_imports(rel) == []


def _foreign_name_strings(rel: str) -> list[str]:
    """Each ``sys.modules.get("...")`` and ``getLogger("...")`` literal of
    a module that names the JAX package (``lighthouse_tpu`` or a module
    under it): such a string would feed the JAX package's metric catalog
    or loggers from the port, or, where that package is not loaded,
    nothing at all."""
    import ast

    path = os.path.join(REPO, rel)
    bad = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if not (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        func = node.func
        modules_get = (isinstance(func, ast.Attribute) and func.attr == "get"
                       and isinstance(func.value, ast.Attribute)
                       and func.value.attr == "modules"
                       and isinstance(func.value.value, ast.Name)
                       and func.value.value.id == "sys")
        get_logger = ((isinstance(func, ast.Attribute)
                       and func.attr == "getLogger")
                      or (isinstance(func, ast.Name)
                          and func.id == "getLogger"))
        name = node.args[0].value
        if (modules_get or get_logger) and (
                name == "lighthouse_tpu"
                or name.startswith("lighthouse_tpu.")):
            bad.append(f"line {node.lineno}: {name}")
    return bad


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_port_names_no_module_or_logger_of_the_jax_package(rel):
    """Every module name a port module looks up in ``sys.modules`` and
    every logger it names is the port's own (``lighthouse_tpu_torch...``)
    or one outside both packages."""
    assert _foreign_name_strings(rel) == []


def test_name_string_check_catches_the_jax_package(tmp_path, monkeypatch):
    """The check above flags the JAX package's names and passes the
    port's."""
    src = tmp_path / "probe.py"
    src.write_text(
        'import logging, sys\n'
        'a = sys.modules.get("lighthouse_tpu.api.metrics_defs")\n'
        'b = logging.getLogger("lighthouse_tpu.network")\n'
        'c = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")\n'
        'd = logging.getLogger("lighthouse_tpu_torch.network")\n'
        'e = sys.modules.get("torch")\n')
    monkeypatch.setattr(sys.modules[__name__], "REPO", str(tmp_path))
    assert _foreign_name_strings("probe.py") == [
        "line 2: lighthouse_tpu.api.metrics_defs",
        "line 3: lighthouse_tpu.network"]
