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
        "lighthouse_tpu_torch.obs.doctor", "lighthouse_tpu_torch.obs.graftwatch"}
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
