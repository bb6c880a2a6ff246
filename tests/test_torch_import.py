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
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]"


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
