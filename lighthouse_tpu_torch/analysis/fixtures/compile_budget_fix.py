"""Seeded fixture for the compile-budget rule.

The file name puts it in the rule's scope (``compile_budget``). Two
lane-keyed programs (functions with a ``lanes`` parameter) and the call
sites that key them; then kernel entries launched inside and outside
roofline-tracked device programs. Every true-positive line carries a
``seeded`` marker.
"""
import torch

from lighthouse_tpu_torch import kernels
from lighthouse_tpu_torch.kernels import HASH64
from lighthouse_tpu_torch.obs.roofline import track_roofline, tracked

LANES = 10240
SMALL = 128


def replicated_prep(mesh, sets, lanes: int, backend=None):
    return [mesh, sets, lanes, backend]


def sharded_verify(mesh, sets, lanes: int):
    # forwarding its own lane count adds no shape
    return replicated_prep(mesh, sets, lanes)


def pad_batch(sets, lanes: int):
    return sets + [None] * (lanes - len(sets))


def budget_ok(mesh, sets):
    # the two sanctioned lane counts, each used twice
    replicated_prep(mesh, sets, LANES)
    replicated_prep(mesh, sets, SMALL)
    replicated_prep(mesh, sets, lanes=LANES)
    return sharded_verify(mesh, sets, SMALL)


def third_shape(mesh, sets):
    return replicated_prep(mesh, sets, 256)  # seeded


def raw_length_key(sets):
    n = len(sets)
    return pad_batch(sets, n)  # seeded


def shape_key_ok(mesh, x, sets):
    # a tensor's shape is a sanctioned key (and the second for the
    # program, so no budget finding either)
    return sharded_verify(mesh, sets, x.shape[0])


# -- roofline pairing: kernel entries ----------------------------------------

def _cost(out, x):
    return 0, 0


@tracked("fixture.hash", _cost)
def tracked_launch(x, out):
    HASH64.launch(x.data_ptr(), out.data_ptr(), 1, 0)
    return out


def _inner_launch(x, out):
    kernels.HASH64.launch(x.data_ptr(), out.data_ptr(), 1, 0)


@tracked("fixture.inner", _cost)
def tracked_caller(x, out):
    # the helper's only caller is tracked: its launch is metered
    _inner_launch(x, out)
    return out


def _wrapped(x, out):
    kernels.HASH64.launch(x.data_ptr(), out.data_ptr(), 1, 0)
    return out


WRAPPED = track_roofline("fixture.wrapped", _wrapped, _cost)


def bare_launch(x):
    out = torch.empty_like(x)
    kernels.HASH64.launch(x.data_ptr(), out.data_ptr(), 1, 0)  # seeded
    return out


def _shared_helper(x, out):
    HASH64.launch(x.data_ptr(), out.data_ptr(), 1, 0)  # seeded


@tracked("fixture.shared", _cost)
def tracked_user(x, out):
    _shared_helper(x, out)
    return out


def untracked_user(x, out):
    # a second, unmetered way in: the helper's launch is flagged
    _shared_helper(x, out)
    return out
