"""graftwatch doctor — offline diagnosis of flight-recorder dumps.

Load a versioned dump written by :mod:`obs.flight`, and for every
incident in it correlate the breach with co-occurring signals from the
bundled time-series window — runtime kernel builds, device transfer
bytes, processor shedding and queue depth, reorgs, block-import
throughput. The diagnosis is deterministic over the dump content, so a
checked-in fixture dump pins the report as a golden file.

    python -m lighthouse_tpu_torch.obs.doctor DUMP.json [--json]

Exit codes: 0 report produced, 2 unreadable/invalid dump, 3 dump format
version unsupported.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..api.metrics_defs import PORT_NAMES
from .flight import FORMAT_VERSION


class DoctorError(Exception):
    """Unreadable or unsupported dump."""

    def __init__(self, message: str, exit_code: int = 2):
        super().__init__(message)
        self.exit_code = exit_code


def load(path: str) -> dict:
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as exc:
        raise DoctorError(f"cannot read dump {path!r}: {exc}") from exc
    if not isinstance(doc, dict) or doc.get("format") != "graftwatch-dump":
        raise DoctorError(f"{path!r} is not a graftwatch dump")
    if doc.get("version") != FORMAT_VERSION:
        raise DoctorError(
            f"dump version {doc.get('version')!r} unsupported "
            f"(doctor speaks {FORMAT_VERSION})", exit_code=3)
    return doc


def _window_indices(slots: list[int], opened: int,
                    resolved: int | None, pre: int = 2,
                    post: int = 1) -> list[int]:
    """Ring rows inside [opened - pre, resolved + post] (open-ended when
    unresolved)."""
    lo = opened - pre
    hi = None if resolved is None else resolved + post
    return [i for i, s in enumerate(slots)
            if s >= lo and (hi is None or s <= hi)]


def _vals(series: dict, name: str, idx: list[int]) -> list[float]:
    vals = series.get(name) or []
    return [vals[i] for i in idx
            if i < len(vals) and vals[i] is not None]


def _stats(vals: list[float]) -> dict:
    if not vals:
        return {"n": 0}
    return {"n": len(vals), "min": min(vals), "max": max(vals),
            "sum": sum(vals)}


#: (series name, kind) scanned for every incident; "delta" series sum
#: activity over the window, "level" series report their peak
_COSIGNALS = [
    (PORT_NAMES["jax_compile_total"], "delta", "runtime nvcc kernel builds"),
    (PORT_NAMES["jax_compile_seconds_total"], "delta", "nvcc build seconds"),
    (PORT_NAMES["jax_compile_cache_misses_total"], "delta",
     "kernel-library cache misses"),
    ("device_hbm_bytes_in_use", "level", "HBM bytes in use"),
    ("process_resident_memory_bytes", "level", "host RSS bytes"),
    (PORT_NAMES["jax_transfer_host_to_device_bytes_total"], "delta",
     "host->device transfer bytes"),
    (PORT_NAMES["jax_transfer_device_to_host_bytes_total"], "delta",
     "device->host transfer bytes"),
    ("beacon_processor_work_dropped_total", "delta",
     "processor work items shed"),
    ("beacon_processor_queue_length", "level",
     "processor queue depth"),
    ("beacon_reorgs_total", "delta", "head reorgs"),
    ("beacon_block_imported_total", "delta", "blocks imported"),
    ("gossipsub_validation_reject_total", "delta",
     "gossip messages rejected"),
    ("sync_range_blocks_imported_total", "delta",
     "range-sync blocks imported"),
    ("sync_batch_validation_rejects_total", "delta",
     "sync batches rejected at download time"),
    ("sync_request_deadline_expired_total", "delta",
     "sync request deadlines expired"),
    ("sync_peer_quarantined_total", "delta",
     "sync peers quarantined"),
    ("api_requests_total", "delta", "serving-tier requests served"),
    ("api_shed_total", "delta", "serving-tier requests shed"),
    ("replay_blocks_committed_total", "delta",
     "replay blocks committed"),
    ("replay_sigs_deduped_total", "delta",
     "replay proposal signatures deduped"),
    ("replay_queue_depth_signature", "level",
     "replay signature queue depth"),
    ("replay_queue_depth_commit", "level",
     "replay commit queue depth"),
]


def _correlate_incident(inc: dict, slots: list[int],
                        series: dict) -> dict:
    idx = _window_indices(slots, int(inc["opened_slot"]),
                          inc.get("resolved_slot"))
    win_slots = [slots[i] for i in idx]
    out = {
        "slo": inc["slo"],
        "opened_slot": inc["opened_slot"],
        "resolved_slot": inc.get("resolved_slot"),
        "worst_value": inc.get("worst_value"),
        "budget": inc.get("budget"),
        "detail": inc.get("detail", ""),
        "window_slots": [min(win_slots), max(win_slots)]
        if win_slots else None,
        "correlations": [],
    }
    # the breached metric's own trajectory always leads the diagnosis —
    # a correlated report is never empty for a well-formed dump
    metric = inc.get("metric", "")
    own_names = [n for n in (metric, metric + ".p95", metric + ".count")
                 if n in series]
    for name in own_names or [metric]:
        st = _stats(_vals(series, name, idx))
        out["correlations"].append({
            "signal": name, "kind": "breached_metric", "stats": st,
            "note": "trajectory of the metric the SLO watches"})
    for name, kind, label in _COSIGNALS:
        vals = _vals(series, name, idx)
        st = _stats(vals)
        if st["n"] == 0:
            continue
        active = (st["sum"] > 0) if kind == "delta" else (st["max"] > 0)
        if not active:
            continue
        out["correlations"].append({
            "signal": name, "kind": kind, "stats": st, "note": label})
    return out


def diagnose(doc: dict) -> dict:
    """Correlated diagnosis over every incident in a loaded dump."""
    ts = doc.get("timeseries") or {}
    slots = ts.get("slots") or []
    series = ts.get("series") or {}
    incidents = doc.get("incidents") or []
    spans = (doc.get("chrome_trace") or {}).get("traceEvents") or []
    return {
        "reason": doc.get("reason"),
        "slot": doc.get("slot"),
        "version": doc.get("version"),
        "window_slots": len(slots),
        "span_events": len(spans),
        "cuda": doc.get("cuda") or {},
        "device": doc.get("device"),
        "chains": doc.get("chains") or [],
        "processors": doc.get("processors") or [],
        "sync": doc.get("sync"),
        "serving": doc.get("serving"),
        "replay": doc.get("replay"),
        "critpath": doc.get("critpath"),
        "recovery": doc.get("recovery"),
        "incidents": [_correlate_incident(i, slots, series)
                      for i in incidents],
    }


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.4g}"
    return str(int(v))


def render(diag: dict) -> str:
    lines = [
        f"graftwatch doctor — dump v{diag['version']} "
        f"(reason {diag['reason']}, slot {_fmt_num(diag['slot'])}, "
        f"{diag['window_slots']} slots of series, "
        f"{diag['span_events']} span events)",
    ]
    cuda = diag.get("cuda") or {}
    if cuda:
        lines.append(
            "  cuda: "
            f"{_fmt_num(cuda.get('builds'))} nvcc builds "
            f"({_fmt_num(cuda.get('build_seconds'))} s), "
            f"{_fmt_num(cuda.get('cache_hits'))} build-cache hits, "
            f"{_fmt_num(cuda.get('libraries_loaded'))} libraries bound, "
            f"{_fmt_num(cuda.get('h2d_bytes'))} B h2d, "
            f"{_fmt_num(cuda.get('d2h_bytes'))} B d2h")
    # dumps without a device section render nothing for it (same
    # contract as sync below)
    dev = diag.get("device")
    if isinstance(dev, dict):
        if "error" in dev:
            lines.append(f"  device: <{dev['error']}>")
        else:
            hbm = dev.get("hbm")
            if isinstance(hbm, list):
                in_use = sum(r.get("bytes_in_use") or 0 for r in hbm)
                limit = sum(r.get("bytes_limit") or 0 for r in hbm)
                hbm_s = f"HBM {_fmt_num(in_use)}/{_fmt_num(limit)} B"
                if any("used_by_all" in r for r in hbm):
                    used = sum(r.get("used_by_all") or 0 for r in hbm)
                    hbm_s += f" ({_fmt_num(used)} B used by all)"
            else:
                hbm_s = f"HBM {hbm}"
            lines.append(
                f"  device: {dev.get('platform', '?')} "
                f"({dev.get('device_kind', '?')}) x "
                f"{_fmt_num(dev.get('chip_count'))}, {hbm_s}")
            cc = dev.get("compile_cache") or {}
            if "error" not in cc and cc:
                lines.append(
                    f"    compile cache: {_fmt_num(cc.get('hits'))} hits, "
                    f"{_fmt_num(cc.get('misses'))} misses")
            roof = dev.get("roofline") or {}
            if "error" not in roof:
                for prog in sorted(roof):
                    for rec in roof[prog]:
                        if not isinstance(rec, dict):
                            continue
                        if rec.get("cost") == "unavailable":
                            lines.append(
                                f"    roofline {prog}: cost unavailable "
                                f"({rec.get('platform', '?')})")
                            continue
                        util = rec.get("utilization_of_peak")
                        util_s = ("-" if util is None
                                  else f"{util * 100:.2g}% of peak")
                        lines.append(
                            f"    roofline {prog}: "
                            f"{_fmt_num(rec.get('ops'))} int ops, "
                            f"{_fmt_num(rec.get('bytes'))} B, "
                            f"{util_s} ({rec.get('platform', '?')})")
            attr = dev.get("attribution") or {}
            for owner in sorted(attr):
                for label in sorted(attr[owner]):
                    rec = attr[owner][label]
                    lines.append(
                        f"    attributed {owner}/{label}: "
                        f"{_fmt_num(rec.get('live_bytes'))} B live "
                        f"(peak {_fmt_num(rec.get('peak_bytes'))})")
    for ch in diag.get("chains") or []:
        if "error" in ch:
            lines.append(f"  chain: <{ch['error']}>")
        else:
            lines.append(
                f"  chain: head slot {_fmt_num(ch.get('head_slot'))} "
                f"@ clock {_fmt_num(ch.get('clock_slot'))}, "
                f"finalized epoch {_fmt_num(ch.get('finalized_epoch'))}, "
                f"{_fmt_num(ch.get('proto_nodes'))} proto nodes")
    for pr in diag.get("processors") or []:
        if "error" not in pr:
            lines.append(
                f"  processor: {_fmt_num(pr.get('processed'))} processed, "
                f"{_fmt_num(pr.get('dropped'))} dropped, "
                f"high water {_fmt_num(pr.get('high_water'))}")
    # dumps older than the sync section simply lack the key — render
    # nothing rather than "not recorded" so golden reports stay stable
    for sn in diag.get("sync") or []:
        if not isinstance(sn, dict):
            continue
        if "error" in sn:
            lines.append(f"  sync: <{sn['error']}>")
            continue
        backoff = sn.get("backoff") or {}
        quarantined = backoff.get("quarantined") or {}
        rejects = sn.get("validation_rejects") or []
        lines.append(
            f"  sync: {sn.get('state', '?')}, "
            f"{len(sn.get('inflight') or [])} in flight, "
            f"{_fmt_num(sn.get('imported_total'))} blocks imported, "
            f"{len(rejects)} validation reject(s), "
            f"{len(quarantined)} peer(s) quarantined")
        for rj in rejects[-3:]:
            lines.append(
                f"    rejected: peer {rj.get('peer')} "
                f"[{_fmt_num(rj.get('start'))},"
                f"+{_fmt_num(rj.get('count'))}) — {rj.get('reason')}")
    # dumps without a serving section render nothing for it (same
    # contract as sync above)
    for sv in diag.get("serving") or []:
        if not isinstance(sv, dict):
            continue
        if "error" in sv:
            lines.append(f"  serving: <{sv['error']}>")
            continue
        ratio = sv.get("cache_hit_ratio")
        ratio_s = "-" if ratio is None else f"{ratio:.2f}"
        lines.append(
            f"  serving: {_fmt_num(sv.get('requests'))} requests, "
            f"queue depth {_fmt_num(sv.get('queue_depth'))} "
            f"(high water {_fmt_num(sv.get('queue_high_water'))}), "
            f"cache hit ratio {ratio_s} "
            f"({_fmt_num(sv.get('cache_entries'))} entries), "
            f"{_fmt_num(sv.get('coalesced'))} coalesced, "
            f"{_fmt_num(sv.get('shed_total'))} shed")
        for sl in (sv.get("slowest") or [])[:3]:
            lines.append(
                f"    slowest: {sl.get('endpoint')} "
                f"{_fmt_num(sl.get('worst_ms'))} ms worst")
    # dumps without a replay section render nothing for it (same
    # contract as sync above)
    for rp in diag.get("replay") or []:
        if not isinstance(rp, dict):
            continue
        if "error" in rp:
            lines.append(f"  replay: <{rp['error']}>")
            continue
        last = rp.get("last_segment") or {}
        lines.append(
            f"  replay: {'ACTIVE' if rp.get('active') else 'idle'}, "
            f"commit seq {_fmt_num(rp.get('commit_seq'))}, "
            f"{_fmt_num(rp.get('blocks_committed'))} blocks committed "
            f"over {_fmt_num(rp.get('segments_replayed'))} segment(s), "
            f"{_fmt_num(rp.get('sigs_deduped'))} sigs deduped, "
            f"queue high water "
            f"{_fmt_num((rp.get('queue_high_water') or {}).get('signature'))}"
            f"/"
            f"{_fmt_num((rp.get('queue_high_water') or {}).get('commit'))}")
        occ = last.get("occupancy") or {}
        if occ:
            occ_s = " ".join(f"{k}={occ[k]:.2f}" for k in sorted(occ))
            lines.append(
                f"    last segment: {_fmt_num(last.get('blocks'))} blocks "
                f"/ {_fmt_num(last.get('epochs'))} epochs at "
                f"{last.get('epochs_per_sec', 0.0):.2f} epochs/s — "
                f"occupancy {occ_s}")
    # dumps without a critpath section render nothing for it (same
    # contract as sync above)
    cp = diag.get("critpath")
    if isinstance(cp, dict):
        if "error" in cp:
            lines.append(f"  critical path: <{cp['error']}>")
        else:
            from .critpath import render_critical_path
            title = "worst block trace"
            nodes = cp.get("nodes") or []
            if nodes:
                title += f" across {len(nodes)} node(s)"
            for ln in render_critical_path(cp, title).splitlines():
                lines.append("  " + ln)
    rec = diag.get("recovery")
    if rec:
        repairs = rec.get("repairs") or []
        lines.append(
            "  recovery: restored="
            + ("yes" if rec.get("restored") else "no")
            + (", fork choice REBUILT" if rec.get("fork_choice_rebuilt")
               else "")
            + f", seq {_fmt_num(rec.get('seq'))}, "
            f"{len(repairs)} repair(s), "
            f"{_fmt_num(rec.get('op_pool_skipped'))} op-pool entries "
            f"skipped")
        for r in repairs:
            lines.append(f"    repaired: {r}")
        if repairs:
            lines.append(
                "    note: incidents shortly after the dump's restart "
                "slot may trace back to the repaired state above")
    if not diag["incidents"]:
        lines.append("no incidents in dump")
    for inc in diag["incidents"]:
        res = inc["resolved_slot"]
        lines.append(
            f"incident {inc['slo']}: opened slot "
            f"{_fmt_num(inc['opened_slot'])}, "
            + ("OPEN" if res is None else f"resolved slot {_fmt_num(res)}")
            + f", worst {_fmt_num(inc['worst_value'])} "
              f"(budget {_fmt_num(inc['budget'])}) — {inc['detail']}")
        for c in inc["correlations"]:
            st = c["stats"]
            if st.get("n"):
                stat_s = (f"n={st['n']} min={_fmt_num(st['min'])} "
                          f"max={_fmt_num(st['max'])} "
                          f"sum={_fmt_num(st['sum'])}")
            else:
                stat_s = "no samples in window"
            lines.append(f"  - {c['signal']} [{c['kind']}]: {stat_s}"
                         f" — {c['note']}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="graftwatch doctor: offline "
                                             "diagnosis of a flight dump")
    ap.add_argument("path", help="flight-recorder dump file")
    ap.add_argument("--json", action="store_true",
                    help="print the diagnosis as JSON instead of text")
    args = ap.parse_args(argv)
    try:
        doc = load(args.path)
    except DoctorError as e:
        print(str(e), file=sys.stderr)
        return e.exit_code
    diag = diagnose(doc)
    print(json.dumps(diag, indent=2) if args.json else render(diag))
    return 0


if __name__ == "__main__":
    sys.exit(main())
