"""Seeded fixture for the trace-safety rule.

The device programs are the functions built with ``@tracked`` /
``track_roofline`` / ``tracked(...)(fn)``. Every true-positive line
carries a ``seeded`` marker; everything else — including the tricky
true-negatives below — must stay silent.
"""
import time

import torch

from lighthouse_tpu_torch.obs.cuda_accounting import host_readback
from lighthouse_tpu_torch.obs.roofline import track_roofline, tracked
from lighthouse_tpu_torch.obs.tracing import annotate, span


def _cost(out, *args, **kwargs):
    return 0, 0


@tracked("fixture.bad", _cost)
def bad_program(x):
    print("launching", x)  # seeded
    t0 = time.time()  # seeded
    y = x * 2
    host = float(y)  # seeded
    return y + host * t0


@tracked("fixture.sync", _cost)
def bad_sync(x):
    y = x + 1
    torch.cuda.synchronize()  # seeded
    return y


@tracked("fixture.item", _cost)
def bad_item(x):
    n = x.sum().item()  # seeded
    return n


def _helper(v):
    v.tolist()  # seeded
    return v


@tracked("fixture.calls_helper", _cost)
def calls_helper(x):
    # reachability: _helper has no decorator but is called from a root
    return _helper(x)


def _wrapped_later(x):
    return bool(x.any())  # seeded


WRAPPED = track_roofline("fixture.wrapped", _wrapped_later, _cost)


def _call_wrapped(x):
    return int(x[0])  # seeded


CALL_WRAPPED = tracked("fixture.call_wrapped", _cost)(_call_wrapped)


# -- true negatives ----------------------------------------------------------

def not_a_program(x):
    # host-side code may sync and print freely
    print("host logging is fine")
    return float(x)


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _plain(x):
    # the host's plain version: reached only from CPU dispatches
    return [int(v) for v in x.tolist()]


@tracked("fixture.good", _cost)
def good_program(x, n_live: int, limit: int | None = None):
    rows = x.shape[0]           # host metadata: no sync
    scale = float(rows)
    k = len(x.shape)
    words = int(x.numel()) + int(n_live)   # a host-typed parameter
    if limit is not None:
        words = min(words, int(limit))
    if _on_cpu(x):
        # the plain version on a CPU tensor syncs nothing
        return _plain(x), int(x.sum())
    if x.device.type == "cpu":
        return float(x.max())
    ok = bool(host_readback(x.all()))    # the accounted final readback
    return x * scale + k + words, ok


def _cpu_only(x):
    return x.tolist()


@tracked("fixture.dispatch", _cost)
def good_dispatch(x):
    if not _on_cpu(x):
        return x + 1
    else:
        return _cpu_only(x)


# -- graftpath causal-scope discipline ----------------------------------------

def on_deliver_bare(peer, topic, data):
    # delivery callback (peer param) opening a span with no causal
    # identity: the cross-node stitcher can never join this trace
    with span("gossip_deliver"):  # seeded
        return data


def on_deliver_two_bare(peer, data):
    with span("gossip_deliver"):  # seeded
        with span("rpc_serve"):  # seeded
            return data


def on_deliver_with_mid(peer, topic, data, mid):
    # a causal kwarg on the span clears the callback
    with span("gossip_deliver", message_id=mid):
        return data


def on_serve_with_annotate(peer, req):
    # annotate() with a causal key clears the whole function
    with span("rpc_serve"):
        annotate(req_id="ab12")
        return req


def pump_without_peer(topic, data):
    # not a delivery callback (no peer param): bare spans are fine
    with span("gossip_deliver"):
        return data
