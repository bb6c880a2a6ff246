"""Chain persistence: fork choice, head, op pool — restart resume.

Equivalent of the reference's persisted_fork_choice.rs / persist_head
(beacon_chain.rs:612,662) + operation_pool/persistence.rs: everything needed
to resume after a restart is written to the hot DB under ITEM keys, and
`ClientGenesis::FromStore` boots from it.

Crash contract (the sequence-number protocol):

`persist_chain` commits THREE batches in a fixed order, all stamped with
the same monotonic sequence number (meta key ``persist_seq``):

1. fork-choice snapshot (JSON doc carries ``"seq"``) + the advanced
   ``persist_seq`` meta — one atomic batch;
2. the head item (``<Q`` seq || 32-byte head root);
3. the op-pool snapshot (JSON doc carries ``"seq"``).

Because the store log is append-only and each batch is one CRC'd record,
a crash can only leave a *prefix* of the sequence: the head's seq is
never ahead of the fork-choice seq.  `resume_chain` exploits that to
repair rather than trust:

- fork-choice snapshot unreadable (torn/corrupt/flipped bits) → rebuild
  the proto array from stored blocks, anchored at the split/finalized
  state (hot states below the split are pruned, so nothing older can
  re-enter);
- head seq != fork-choice seq (crash between batches 1 and 2) → the head
  item is stale: derive the head from the restored fork choice instead;
- head's state unloadable → walk back parent-by-parent to the newest
  ancestor whose state IS loadable;
- individually corrupt op-pool entries → skipped and counted, never
  fatal.

Any repair is re-persisted immediately so a subsequent `fsck` run is
clean, and the whole episode is recorded in `LAST_RECOVERY` for the
graftwatch flight recorder / offline doctor.
"""
from __future__ import annotations

import json
import logging
import struct

from ..fork_choice import ForkChoice
from ..fork_choice.proto_array import ExecutionStatus, ProtoNode, VoteTracker
from ..store import StoreOp
from ..utils.crashpoints import crashpoint

FORK_CHOICE_KEY = b"fork_choice"
HEAD_KEY = b"head"
OP_POOL_KEY = b"op_pool"
PERSIST_SEQ_META = b"persist_seq"

log = logging.getLogger("lighthouse_tpu_torch.chain")

#: report of the most recent `resume_chain` in this process (None = never
#: resumed).  Embedded in the flight-recorder dump so the offline doctor
#: can correlate post-restart incidents with what recovery repaired.
LAST_RECOVERY: dict | None = None


def last_recovery_report() -> dict | None:
    return LAST_RECOVERY


def _count(name: str, amount: float = 1) -> None:
    import sys
    md = sys.modules.get("lighthouse_tpu_torch.api.metrics_defs")
    if md is not None:
        md.count(name, amount)


def _hex(b: bytes | None) -> str | None:
    return b.hex() if b is not None else None


def _unhex(s) -> bytes | None:
    return bytes.fromhex(s) if s is not None else None


# -- persist -----------------------------------------------------------------


def load_persist_seq(store) -> int:
    raw = store._get_meta(PERSIST_SEQ_META)
    if raw is None or len(raw) != 8:
        return 0
    return struct.unpack("<Q", raw)[0]


def _fork_choice_doc(chain, seq: int | None) -> dict:
    fc = chain.fork_choice
    pa = fc.proto_array
    doc = {
        "justified": [fc.justified_checkpoint[0],
                      _hex(fc.justified_checkpoint[1])],
        "finalized": [fc.finalized_checkpoint[0],
                      _hex(fc.finalized_checkpoint[1])],
        "u_justified": [fc.unrealized_justified_checkpoint[0],
                        _hex(fc.unrealized_justified_checkpoint[1])],
        "u_finalized": [fc.unrealized_finalized_checkpoint[0],
                        _hex(fc.unrealized_finalized_checkpoint[1])],
        "current_slot": fc.current_slot,
        "equivocating": sorted(fc.equivocating_indices),
        "votes": [[_hex(v.current_root), _hex(v.next_root), v.next_epoch]
                  for v in fc.votes],
        "nodes": [{
            "slot": n.slot, "root": _hex(n.root),
            "parent": n.parent, "state_root": _hex(n.state_root),
            "target": _hex(n.target_root),
            "jc": [n.justified_checkpoint[0], _hex(n.justified_checkpoint[1])],
            "fc": [n.finalized_checkpoint[0], _hex(n.finalized_checkpoint[1])],
            "ujc": ([n.unrealized_justified_checkpoint[0],
                     _hex(n.unrealized_justified_checkpoint[1])]
                    if n.unrealized_justified_checkpoint else None),
            "ufc": ([n.unrealized_finalized_checkpoint[0],
                     _hex(n.unrealized_finalized_checkpoint[1])]
                    if n.unrealized_finalized_checkpoint else None),
            "weight": n.weight,
            "best_child": n.best_child, "best_descendant": n.best_descendant,
            "exec": n.execution_status.value,
            "exec_hash": _hex(n.execution_block_hash),
        } for n in pa.nodes],
    }
    if seq is not None:
        doc["seq"] = seq
    return doc


def _op_pool_doc(chain, seq: int | None) -> dict:
    from ..ssz import serialize
    pool = chain.op_pool
    T = chain.T
    with pool._lock:
        atts = [a for bucket in pool._attestations.values() for a in bucket]
        doc = {
            "attestations": [serialize(type(a).ssz_type, a).hex()
                             for a in atts],
            "att_electra": [hasattr(a, "committee_bits") for a in atts],
            "exits": [serialize(T.SignedVoluntaryExit.ssz_type, e).hex()
                      for e in pool._voluntary_exits.values()],
            "proposer_slashings": [
                serialize(T.ProposerSlashing.ssz_type, s).hex()
                for s in pool._proposer_slashings.values()],
            "attester_slashings": [
                serialize(type(s).ssz_type, s).hex()
                for s in pool._attester_slashings],
            "as_electra": [
                "Electra" in type(s).__name__
                for s in pool._attester_slashings],
            "bls_changes": [
                serialize(T.SignedBLSToExecutionChange.ssz_type, c).hex()
                for c in pool._bls_changes.values()],
        }
    if seq is not None:
        doc["seq"] = seq
    return doc


def persist_fork_choice(chain, seq: int | None = None) -> None:
    """Batch 1: fork-choice snapshot + advanced persist_seq, atomically."""
    doc = _fork_choice_doc(chain, seq)
    ops = [StoreOp.put_item(FORK_CHOICE_KEY, json.dumps(doc).encode())]
    if seq is not None:
        ops.append(StoreOp.put_meta(PERSIST_SEQ_META,
                                    struct.pack("<Q", seq)))
    chain.store.do_atomically(ops, fsync=False)


def persist_head(chain, seq: int | None = None) -> None:
    """Batch 2: the head item, seq-stamped so a crash between batches is
    detectable as head_seq != fork_choice_seq on resume."""
    head_root = chain.head().head_block_root
    value = (struct.pack("<Q", seq) + head_root if seq is not None
             else head_root)
    chain.store.do_atomically([StoreOp.put_item(HEAD_KEY, value)],
                              fsync=False)


def persist_op_pool(chain, seq: int | None = None) -> None:
    """Batch 3: op-pool snapshot."""
    doc = _op_pool_doc(chain, seq)
    chain.store.do_atomically(
        [StoreOp.put_item(OP_POOL_KEY, json.dumps(doc).encode())],
        fsync=False)


def persist_chain(chain) -> None:
    seq = load_persist_seq(chain.store) + 1
    persist_fork_choice(chain, seq)
    crashpoint("persist:between_fc_and_head")
    persist_head(chain, seq)
    crashpoint("persist:between_head_and_op_pool")
    persist_op_pool(chain, seq)


# -- restore -----------------------------------------------------------------


def restore_fork_choice(chain) -> bool:
    ok, _seq = _restore_fork_choice(chain)
    return ok


def _restore_fork_choice(chain) -> tuple[bool, int | None]:
    """(restored, snapshot_seq).  Never raises: torn/corrupt snapshots
    return (False, None) so `resume_chain` can fall through to the
    rebuild path instead of hard-crashing at boot."""
    raw = chain.store.get_item(FORK_CHOICE_KEY)
    if raw is None:
        return False, None
    try:
        doc = json.loads(raw)
        fc = chain.fork_choice
        justified = (doc["justified"][0], _unhex(doc["justified"][1]))
        finalized = (doc["finalized"][0], _unhex(doc["finalized"][1]))
        nodes = []
        indices = {}
        for nd in doc["nodes"]:
            node = ProtoNode(
                slot=nd["slot"], root=_unhex(nd["root"]),
                parent=nd["parent"],
                state_root=_unhex(nd["state_root"]),
                target_root=_unhex(nd["target"]),
                justified_checkpoint=(nd["jc"][0], _unhex(nd["jc"][1])),
                finalized_checkpoint=(nd["fc"][0], _unhex(nd["fc"][1])),
                unrealized_justified_checkpoint=(
                    (nd["ujc"][0], _unhex(nd["ujc"][1]))
                    if nd.get("ujc") else None),
                unrealized_finalized_checkpoint=(
                    (nd["ufc"][0], _unhex(nd["ufc"][1]))
                    if nd.get("ufc") else None),
                weight=nd["weight"], best_child=nd["best_child"],
                best_descendant=nd["best_descendant"],
                execution_status=ExecutionStatus(nd["exec"]),
                execution_block_hash=_unhex(nd["exec_hash"]))
            indices[node.root] = len(nodes)
            nodes.append(node)
        votes = [VoteTracker(_unhex(c), _unhex(nx), e)
                 for c, nx, e in doc["votes"]]
    except Exception as exc:
        log.warning("fork-choice snapshot unreadable (%r); will rebuild "
                    "from stored blocks", exc)
        return False, None
    # parsed cleanly: only now mutate the live fork choice
    fc.justified_checkpoint = justified
    fc.finalized_checkpoint = finalized
    fc.unrealized_justified_checkpoint = (doc["u_justified"][0],
                                          _unhex(doc["u_justified"][1]))
    fc.unrealized_finalized_checkpoint = (doc["u_finalized"][0],
                                          _unhex(doc["u_finalized"][1]))
    fc.current_slot = doc["current_slot"]
    fc.equivocating_indices = set(doc["equivocating"])
    fc.votes = votes
    pa = fc.proto_array
    pa.nodes = nodes
    pa.indices = indices
    pa.justified_checkpoint = justified
    pa.finalized_checkpoint = finalized
    return True, doc.get("seq")


def _anchor_fork_choice_at_split(chain) -> ForkChoice | None:
    """A fresh fork choice anchored at the split/finalized block — the
    deepest point whose state is still materialized in hot.  None when the
    split state or its summary is itself unusable (caller keeps the
    genesis-anchored instance)."""
    store = chain.store
    summary = store.hot_state_summary(store.split.state_root)
    if summary is None:
        return None
    try:
        anchor_state = store.get_hot_state(store.split.state_root)
    except Exception:
        anchor_state = None
    if anchor_state is None:
        return None
    anchor_root = summary[1]          # latest_block_root at the split state
    fc = ForkChoice(chain.spec, anchor_root, anchor_state)
    fc.balances_provider = chain._justified_balances
    return fc


def _replay_missing_blocks(chain) -> int:
    """Feed every stored hot block that fork choice doesn't know (and whose
    parent it does) back through on_block.  Ascending slot order makes one
    pass sufficient; blocks with unloadable states are skipped — they're
    exactly what the head walk-back ladder routes around."""
    fc = chain.fork_choice
    current_slot = chain.slot()
    added = 0
    for root, blk in chain.store.iter_hot_blocks():
        msg = blk.message
        if fc.contains_block(root) or \
                not fc.contains_block(msg.parent_root):
            continue
        try:
            state = chain.store.get_hot_state(msg.state_root)
        except Exception:
            state = None
        if state is None:
            continue
        try:
            fc.on_block(max(current_slot, msg.slot), msg, root, state)
        except Exception as exc:
            log.warning("fork-choice rebuild: skipping block %s: %r",
                        root.hex()[:12], exc)
            continue
        added += 1
    return added


def rebuild_fork_choice(chain) -> int:
    """Reconstruct fork choice from stored blocks (snapshot unreadable or
    absent).  Returns the number of blocks (re-)registered."""
    if chain.store.split.slot > 0:
        fc = _anchor_fork_choice_at_split(chain)
        if fc is not None:
            with chain._lock:
                chain.fork_choice = fc
        else:
            log.warning("fork-choice rebuild: split state unusable, "
                        "keeping the anchor-state instance")
    return _replay_missing_blocks(chain)


def restore_op_pool(chain) -> int:
    n, _skipped, _seq = _restore_op_pool(chain)
    return n


def _restore_op_pool(chain) -> tuple[int, int, int | None]:
    """(restored, skipped, seq): each entry decodes independently, so one
    flipped bit costs one attestation, not the whole pool."""
    from ..ssz import deserialize
    raw = chain.store.get_item(OP_POOL_KEY)
    if raw is None:
        return 0, 0, None
    try:
        doc = json.loads(raw)
    except Exception as exc:
        log.warning("op-pool snapshot unreadable (%r); dropping it", exc)
        return 0, 1, None
    T = chain.T
    n = skipped = 0

    def _each(items, fn):
        nonlocal n, skipped
        for it in items:
            try:
                fn(*it) if isinstance(it, tuple) else fn(it)
                n += 1
            except Exception:
                skipped += 1

    _each(list(zip(doc.get("attestations", []),
                   doc.get("att_electra", []))),
          lambda hexa, is_electra: chain.op_pool.insert_attestation(
              deserialize((T.AttestationElectra if is_electra
                           else T.Attestation).ssz_type,
                          bytes.fromhex(hexa))))
    _each(doc.get("exits", []),
          lambda hexe: chain.op_pool.insert_voluntary_exit(
              deserialize(T.SignedVoluntaryExit.ssz_type,
                          bytes.fromhex(hexe))))
    _each(doc.get("proposer_slashings", []),
          lambda hexs: chain.op_pool.insert_proposer_slashing(
              deserialize(T.ProposerSlashing.ssz_type, bytes.fromhex(hexs))))
    _each(list(zip(doc.get("attester_slashings", []),
                   doc.get("as_electra", []))),
          lambda hexs, is_electra: chain.op_pool.insert_attester_slashing(
              deserialize((T.AttesterSlashingElectra if is_electra
                           else T.AttesterSlashing).ssz_type,
                          bytes.fromhex(hexs))))
    _each(doc.get("bls_changes", []),
          lambda hexc: chain.op_pool.insert_bls_to_execution_change(
              deserialize(T.SignedBLSToExecutionChange.ssz_type,
                          bytes.fromhex(hexc))))
    return n, skipped, doc.get("seq")


# -- resume (the repair ladder) ----------------------------------------------


def _try_set_head(chain, head_root: bytes) -> bool:
    head_block = chain.store.get_block(head_root)
    if head_block is None:
        return False
    try:
        head_state = chain.store.get_hot_state(
            head_block.message.state_root)
    except Exception:
        head_state = None
    if head_state is None:
        return False
    from .beacon_chain import CanonicalHead
    with chain._lock:
        chain.canonical_head = CanonicalHead(head_root, head_block,
                                             head_state)
    chain._cache_snapshot(head_root, head_state)
    return True


def _repair_head(chain, head_root: bytes, report: dict) -> bool:
    """Walk back from `head_root` to the newest ancestor whose state is
    loadable; 0 steps is the happy path."""
    root = head_root
    steps = 0
    while root is not None and root != b"\x00" * 32:
        if _try_set_head(chain, root):
            if steps:
                report["repairs"].append(
                    f"head {head_root.hex()[:12]} had no loadable state; "
                    f"walked back {steps} block(s) to {root.hex()[:12]}")
                log.warning("resume: %s", report["repairs"][-1])
            report["head_walked_back"] = steps
            return True
        blk = chain.store.get_block(root)
        if blk is None or blk.message.slot == 0:
            return False
        root = blk.message.parent_root
        steps += 1
    return False


def resume_chain(chain) -> bool:
    """Restore fork choice + head + op pool from the store (FromStore boot),
    repairing whatever a crash tore (module docstring has the ladder).
    Returns True when prior state existed."""
    global LAST_RECOVERY
    report: dict = {"restored": False, "fork_choice_rebuilt": False,
                    "repairs": [], "op_pool_skipped": 0,
                    "head_walked_back": 0, "seq": None}
    LAST_RECOVERY = report
    store = chain.store

    restored, fc_seq = _restore_fork_choice(chain)
    report["restored"] = restored
    report["seq"] = fc_seq
    if restored:
        # snapshot may predate the newest imported blocks (crash after the
        # import batch, before the next persist): top it up from the store
        added = _replay_missing_blocks(chain)
        if added:
            report["repairs"].append(
                f"fork choice topped up with {added} stored block(s) "
                f"missing from the snapshot")
    else:
        snapshot_existed = store.get_item(FORK_CHOICE_KEY) is not None
        added = rebuild_fork_choice(chain)
        if snapshot_existed:
            report["fork_choice_rebuilt"] = True
            report["repairs"].append(
                f"fork-choice snapshot unreadable; rebuilt from stored "
                f"blocks ({added} registered)")
        elif added or store.split.slot > 0 or \
                store.get_item(HEAD_KEY) is not None:
            # no snapshot but real history: a crash beat the first persist
            report["fork_choice_rebuilt"] = True
            report["repairs"].append(
                f"no fork-choice snapshot; rebuilt from stored blocks "
                f"({added} registered)")
        else:
            return False                   # genuinely fresh store

    n_ops, skipped, _pool_seq = _restore_op_pool(chain)
    report["op_pool_skipped"] = skipped
    if skipped:
        report["repairs"].append(
            f"op-pool restore skipped {skipped} corrupt entr"
            f"{'y' if skipped == 1 else 'ies'} (kept {n_ops})")

    # head: trust the persisted item only when its seq matches the
    # fork-choice snapshot's (append order guarantees head_seq <= fc_seq;
    # a mismatch means the crash hit between the two batches)
    head_root = None
    raw_head = store.get_item(HEAD_KEY)
    if raw_head is None and fc_seq is not None:
        # persist_chain always writes the head right after the snapshot,
        # so a seq-stamped snapshot with no head item is the crash
        # landing between the first persist's two batches
        report["repairs"].append(
            f"torn persist: fork-choice snapshot at seq {fc_seq} but no "
            f"head item; deriving head from fork choice")
    if raw_head is not None:
        if len(raw_head) == 40:
            head_seq = struct.unpack("<Q", raw_head[:8])[0]
            head_root = raw_head[8:]
            if fc_seq is not None and head_seq != fc_seq:
                report["repairs"].append(
                    f"torn persist: head item at seq {head_seq} vs "
                    f"fork-choice seq {fc_seq}; deriving head from fork "
                    f"choice")
                head_root = None
        elif len(raw_head) == 32:          # legacy, pre-seq layout
            head_root = raw_head
        else:
            report["repairs"].append("head item malformed; deriving head "
                                     "from fork choice")
    if head_root is not None and \
            not chain.fork_choice.contains_block(head_root):
        report["repairs"].append(
            f"persisted head {head_root.hex()[:12]} unknown to fork "
            f"choice; deriving head from fork choice")
        head_root = None
    if head_root is None:
        try:
            head_root = chain.fork_choice.get_head(chain.slot())
        except Exception as exc:
            log.warning("resume: get_head failed during repair: %r", exc)
            head_root = None
    if head_root is not None:
        if not _repair_head(chain, head_root, report):
            report["repairs"].append(
                f"no ancestor of {head_root.hex()[:12]} has a loadable "
                f"state; keeping the anchor head")
            log.warning("resume: %s", report["repairs"][-1])

    if report["repairs"]:
        _count("store_recovery_repairs_total", len(report["repairs"]))
        log.warning("resume: %d repair(s) applied: %s",
                    len(report["repairs"]), "; ".join(report["repairs"]))
        try:
            # re-persist so the store is internally consistent again
            # (fsck's seq cross-check comes back clean)
            persist_chain(chain)
        except Exception:                  # pragma: no cover - best effort
            log.exception("resume: re-persist after repair failed")
    return True
