"""Seeded fixture for the device-transfer rule.

The module imports torch.distributed, which puts it in the rule's
scope. Every true-positive line carries a ``seeded`` marker; the
true-negatives below (placement on an explicit device, pure host numpy
work, the sanctioned host_readback crossing) must stay silent.
"""
import numpy as np
import torch
import torch.distributed as dist  # noqa: F401  (puts the file in scope)

from lighthouse_tpu_torch.obs.cuda_accounting import host_readback
from lighthouse_tpu_torch.obs.roofline import tracked
from lighthouse_tpu_torch.ops import sha256 as k
from lighthouse_tpu_torch.ops.bls12_381 import fp12_eq


def bad_bare_cuda(arr):
    return torch.from_numpy(arr).cuda()  # seeded


def bad_bare_to(t):
    return t.to("cuda")  # seeded


def bad_factory(n):
    return torch.zeros(n, dtype=torch.int32)  # seeded


def bad_bare_device():
    return torch.device("cuda")  # seeded


def bad_roundtrip(x):
    y = k.hash_pairs(x)
    return y.cpu()  # seeded


def bad_transitive(x, mesh):
    y = x.to(mesh.device)
    z = y + 2
    return np.asarray(z)  # seeded


def bad_item_from_kernel(a, b):
    eq = fp12_eq(a, b)
    return eq.item()  # seeded


def bad_tolist(x, dev):
    out = torch.ones(4, device=dev) * x
    return out.tolist()  # seeded


def _bad_cost(out, mask):
    # a device program's cost reads its tensors back: unaccounted
    return int(mask.numpy().sum())  # seeded


@tracked("fixture.masked", _bad_cost)
def masked_program(mask):
    return mask


@tracked("fixture.loop", lambda out, rows: (0, 0))
def bad_in_program(rows):
    for r in rows:
        yield r.item()  # seeded


# -- true negatives ----------------------------------------------------------

def good_placed(arr, mesh):
    # explicit placement on the rank's device
    return torch.from_numpy(arr).to(mesh.device)


def good_factory(n, dev):
    flag = torch.zeros(n, dtype=torch.int32, device=dev)
    like = torch.empty_like(flag)          # *_like inherits the device
    return flag, like


def good_indexed(t):
    return t.to("cuda:0"), torch.device("cuda", 0)


def good_host_work(n):
    # pure host numpy: padding tables, mesh rows
    table = np.arange(n)
    return np.asarray(table * 2)


def good_readback(x):
    y = fp12_eq(x, x)
    # the sanctioned crossing: byte-accounted readback
    return bool(host_readback(y).all())


def good_after_readback(x):
    y = k.hash_pairs(x)
    host = host_readback(y)
    return host.numpy().tolist()


def _good_cost(out, mask):
    return int(host_readback(mask).numpy().sum())


@tracked("fixture.good_masked", _good_cost)
def good_masked_program(mask):
    return mask


def untracked_helper(mask):
    # not a device program's: a host array in, no taint
    return mask.tolist()
