"""The walker + per-runner handlers (see package docstring)."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

import yaml

from ..network.snappy import decompress_block
from ..specs import minimal_spec
from ..specs.chain_spec import ChainSpec, ForkName

# runners/handlers we declare as not implemented (reported, not silent).
# `networking` (fulu custody-group math) and electra's renamed-away
# deposit_receipt are the only remaining declared skips — neither is a
# case type the reference executes (testing/ef_tests/src/cases/ has no
# networking case; deposit_receipt became deposit_request).
SKIPPED_HANDLERS = {
    ("operations", "deposit_receipt"),
    ("networking", None),
}

FORK_DIRS = {
    "phase0": ForkName.PHASE0, "altair": ForkName.ALTAIR,
    "bellatrix": ForkName.BELLATRIX, "capella": ForkName.CAPELLA,
    "deneb": ForkName.DENEB, "electra": ForkName.ELECTRA,
    # fulu state containers are not implemented; ONLY its fork-agnostic
    # kzg (cells) runner is executed — every other fulu runner is a
    # declared skip (see _run_all)
    "fulu": ForkName.ELECTRA,
}
FULU_RUNNERS = {"kzg"}


@dataclass
class CaseResult:
    path: str
    ok: bool
    skipped: bool = False
    error: str = ""


@dataclass
class _Case:
    """File access wrapper enforcing the skip-proof discipline."""
    dir: Path
    accessed: set = field(default_factory=set)

    def read(self, name: str) -> bytes:
        p = self.dir / name
        self.accessed.add(name)
        return p.read_bytes()

    def read_ssz(self, name: str) -> bytes:
        return decompress_block(self.read(name))

    def read_yaml(self, name: str):
        return yaml.safe_load(self.read(name))

    def has(self, name: str) -> bool:
        return (self.dir / name).exists()

    def unaccessed(self) -> list[str]:
        return sorted(f for f in os.listdir(self.dir)
                      if (self.dir / f).is_file() and f not in self.accessed)


class EfTestRunner:
    def __init__(self, tests_root: str | Path):
        self.root = Path(tests_root)

    def _spec_for(self, config: str) -> ChainSpec:
        if config in ("minimal", "general"):   # general: spec-independent
            return minimal_spec()
        if config == "mainnet":
            from ..specs import mainnet_spec
            return mainnet_spec()
        raise ValueError(f"unknown config {config!r}")

    def run(self) -> list[CaseResult]:
        # conformance means REAL crypto: a caller that left the fake
        # backend active (chain tests) must not turn signature-rejection
        # vectors into false passes.  Pin python for the run, restore
        # after (the reference's real-vs-fake split is two separate runs).
        from ..crypto import bls
        prev = bls.get_backend().name
        if prev == "fake":
            bls.set_backend("python")
        try:
            return self._run_all()
        finally:
            bls.set_backend(prev)

    def _run_all(self) -> list[CaseResult]:
        results: list[CaseResult] = []
        for config_dir in sorted(self.root.iterdir()):
            if not config_dir.is_dir():
                continue
            try:
                spec = self._spec_for(config_dir.name)
            except ValueError as e:
                results.append(CaseResult(config_dir.name, ok=True,
                                          skipped=True, error=str(e)))
                continue
            for fork_dir in sorted(config_dir.iterdir()):
                fork = FORK_DIRS.get(fork_dir.name)
                if fork is None:
                    continue
                for runner_dir in sorted(fork_dir.iterdir()):
                    if fork_dir.name == "fulu" and \
                            runner_dir.name not in FULU_RUNNERS:
                        for case_dir in runner_dir.glob("*/*/*"):
                            results.append(CaseResult(
                                str(case_dir.relative_to(self.root)),
                                ok=True, skipped=True,
                                error="fulu state containers not "
                                      "implemented"))
                        continue
                    results += self._run_runner(spec, fork, runner_dir)
        return results

    def _run_runner(self, spec, fork, runner_dir: Path) -> list[CaseResult]:
        runner = runner_dir.name
        out: list[CaseResult] = []
        for handler_dir in sorted(runner_dir.iterdir()):
            handler = handler_dir.name
            fn = _HANDLERS.get(runner)
            declared_skip = ((runner, None) in SKIPPED_HANDLERS
                             or (runner, handler) in SKIPPED_HANDLERS)
            for suite_dir in sorted(handler_dir.iterdir()):
                for case_dir in sorted(suite_dir.iterdir()):
                    rel = str(case_dir.relative_to(self.root))
                    if declared_skip or fn is None:
                        out.append(CaseResult(
                            rel, ok=True, skipped=True,
                            error="" if declared_skip
                            else f"no handler for runner {runner!r}"))
                        continue
                    case = _Case(case_dir)
                    try:
                        fn(spec, fork, handler, case)
                        missed = case.unaccessed()
                        if missed:
                            out.append(CaseResult(
                                rel, ok=False,
                                error=f"files not consumed: {missed}"))
                        else:
                            out.append(CaseResult(rel, ok=True))
                    except _DeclaredSkip as e:
                        out.append(CaseResult(rel, ok=True, skipped=True,
                                              error=str(e)))
                    except Exception as e:  # a failing case, not a crash
                        out.append(CaseResult(rel, ok=False,
                                              error=f"{type(e).__name__}: {e}"))
        return out


class _DeclaredSkip(Exception):
    pass


def _expect(fn, expect_valid: bool, what: str) -> None:
    """Run a fork-choice step honoring the EF `valid: false` convention."""
    if expect_valid:
        fn()
        return
    try:
        fn()
    except Exception:
        return
    raise AssertionError(f"invalid {what} step was accepted")


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------

def _types(spec):
    from ..containers import get_types
    return get_types(spec.preset)


def _load_state(spec, fork, case: _Case, name: str):
    from ..containers.state import BeaconState
    return BeaconState.from_ssz_bytes(case.read_ssz(name), _types(spec),
                                      spec, fork)


def _ssz_type_for(T, fork, name: str):
    from ..ssz import Root, uint64
    simple = {
        "Checkpoint": T.Checkpoint, "Fork": T.Fork, "ForkData": None,
        "AttestationData": T.AttestationData,
        "BeaconBlockHeader": T.BeaconBlockHeader,
        "SignedBeaconBlockHeader": T.SignedBeaconBlockHeader,
        "Attestation": T.Attestation,
        "IndexedAttestation": T.IndexedAttestation,
        "AttesterSlashing": T.AttesterSlashing,
        "ProposerSlashing": T.ProposerSlashing,
        "Deposit": T.Deposit, "DepositData": T.DepositData,
        "VoluntaryExit": T.VoluntaryExit,
        "SignedVoluntaryExit": T.SignedVoluntaryExit,
        "Eth1Data": T.Eth1Data,
        "SyncAggregate": getattr(T, "SyncAggregate", None),
        "SyncCommittee": getattr(T, "SyncCommittee", None),
        "BeaconBlock": T.BeaconBlock[fork],
        "SignedBeaconBlock": T.SignedBeaconBlock[fork],
        "BeaconBlockBody": T.BeaconBlockBody[fork],
    }
    cls = simple.get(name)
    if cls is None:
        raise _DeclaredSkip(f"ssz_static type {name} not mapped")
    return cls


def _h_ssz_static(spec, fork, handler, case: _Case) -> None:
    from ..ssz import deserialize, htr, serialize
    T = _types(spec)
    cls = _ssz_type_for(T, fork, handler)
    raw = case.read_ssz("serialized.ssz_snappy")
    roots = case.read_yaml("roots.yaml")
    if case.has("value.yaml"):
        case.read("value.yaml")    # structural content covered by the root
    obj = deserialize(cls.ssz_type, raw)
    if serialize(cls.ssz_type, obj) != raw:
        raise AssertionError("ssz roundtrip mismatch")
    got = "0x" + htr(obj).hex()
    if got != roots["root"]:
        raise AssertionError(f"root {got} != {roots['root']}")


_OP_FILES = {
    "attestation": ("attestation.ssz_snappy", "Attestation"),
    "attester_slashing": ("attester_slashing.ssz_snappy",
                          "AttesterSlashing"),
    "block_header": ("block.ssz_snappy", "BeaconBlock"),
    "proposer_slashing": ("proposer_slashing.ssz_snappy",
                          "ProposerSlashing"),
    "voluntary_exit": ("voluntary_exit.ssz_snappy", "SignedVoluntaryExit"),
    "deposit": ("deposit.ssz_snappy", "Deposit"),
    "sync_aggregate": ("sync_aggregate.ssz_snappy", "SyncAggregate"),
    "bls_to_execution_change": ("address_change.ssz_snappy",
                                "SignedBLSToExecutionChange"),
    "withdrawals": ("execution_payload.ssz_snappy", "ExecutionPayload"),
    "deposit_request": ("deposit_request.ssz_snappy", "DepositRequest"),
    "withdrawal_request": ("withdrawal_request.ssz_snappy",
                           "WithdrawalRequest"),
    "consolidation_request": ("consolidation_request.ssz_snappy",
                              "ConsolidationRequest"),
}


def _h_operations(spec, fork, handler, case: _Case) -> None:
    from ..ssz import deserialize
    from ..state_transition import block as blk
    from ..state_transition.block import VerifySignatures
    if handler not in _OP_FILES:
        raise _DeclaredSkip(f"operation {handler} not mapped")
    if case.has("meta.yaml"):
        case.read_yaml("meta.yaml")
    fname, tname = _OP_FILES[handler]
    T = _types(spec)
    pre = _load_state(spec, fork, case, "pre.ssz_snappy")
    if tname in ("SignedBLSToExecutionChange", "DepositRequest",
                 "WithdrawalRequest", "ConsolidationRequest"):
        cls = getattr(T, tname, None)
        if cls is None:
            raise _DeclaredSkip(f"no {tname} type")
    elif tname == "ExecutionPayload":
        cls = T.ExecutionPayload[fork]
    else:
        cls = _ssz_type_for(T, fork, tname)
    op = deserialize(cls.ssz_type, case.read_ssz(fname))
    vs = VerifySignatures.TRUE

    def apply():
        if handler == "attestation":
            blk.process_attestation(pre, op, vs)
        elif handler == "attester_slashing":
            blk.process_attester_slashing(pre, op, vs)
        elif handler == "block_header":
            blk.process_block_header(pre, op)
        elif handler == "proposer_slashing":
            blk.process_proposer_slashing(pre, op, vs)
        elif handler == "voluntary_exit":
            blk.process_voluntary_exit(pre, op, vs)
        elif handler == "deposit":
            blk.process_deposit(pre, op)
        elif handler == "sync_aggregate":
            blk.process_sync_aggregate(pre, op, pre.slot, vs)
        elif handler == "bls_to_execution_change":
            blk.process_bls_to_execution_change(pre, op, vs)
        elif handler == "withdrawals":
            blk.process_withdrawals(pre, op)
        elif handler == "deposit_request":
            blk.process_deposit_request(pre, op)
        elif handler == "withdrawal_request":
            blk.process_withdrawal_request(pre, op)
        elif handler == "consolidation_request":
            blk.process_consolidation_request(pre, op)

    if case.has("post.ssz_snappy"):
        apply()
        post = _load_state(spec, fork, case, "post.ssz_snappy")
        if pre.hash_tree_root() != post.hash_tree_root():
            raise AssertionError("post state root mismatch")
    else:
        try:
            apply()
        except Exception:
            return                   # expected invalid
        raise AssertionError("invalid operation was accepted")


def _h_epoch_processing(spec, fork, handler, case: _Case) -> None:
    from ..state_transition import epoch as ep
    from ..state_transition.helpers import get_total_active_balance
    pre = _load_state(spec, fork, case, "pre.ssz_snappy")
    total = get_total_active_balance(pre)

    def ju_fi():
        if fork == ForkName.PHASE0:
            raise _DeclaredSkip("phase0 ju_fi via full epoch only")
        ep.process_justification_and_finalization(pre, total)

    subs = {
        "justification_and_finalization": ju_fi,
        "inactivity_updates": lambda: ep._process_inactivity_updates(pre),
        "rewards_and_penalties": lambda:
            ep._process_rewards_and_penalties_altair(pre, fork, total),
        "registry_updates": lambda: ep._process_registry_updates(pre, fork),
        "slashings": lambda: ep._process_slashings(pre, fork, total),
        "eth1_data_reset": lambda: ep._process_eth1_data_reset(pre),
        "effective_balance_updates": lambda:
            ep._process_effective_balance_updates(pre),
        "slashings_reset": lambda: ep._process_slashings_reset(pre),
        "randao_mixes_reset": lambda: ep._process_randao_mixes_reset(pre),
        "historical_summaries_update": lambda:
            ep._process_historical_update(pre),
        "historical_roots_update": lambda:
            ep._process_historical_update(pre),
        "participation_flag_updates": lambda:
            ep._process_participation_flag_updates(pre),
        "sync_committee_updates": lambda:
            ep._process_sync_committee_updates(pre),
        "pending_deposits": lambda: ep._process_pending_deposits(pre),
        "pending_consolidations": lambda:
            ep._process_pending_consolidations(pre),
    }
    fn = subs.get(handler)
    if fn is None:
        raise _DeclaredSkip(f"epoch sub-processor {handler} not mapped")
    if case.has("post.ssz_snappy"):
        fn()
        post = _load_state(spec, fork, case, "post.ssz_snappy")
        if pre.hash_tree_root() != post.hash_tree_root():
            raise AssertionError("post state root mismatch")
    else:
        try:
            fn()
        except Exception:
            return
        raise AssertionError("invalid epoch case was accepted")


def _state_transition(state, signed_block) -> None:
    """Full spec state_transition incl. state-root validation."""
    from ..state_transition import per_block_processing, process_slots
    if state.slot < signed_block.message.slot:
        process_slots(state, signed_block.message.slot)
    per_block_processing(state, signed_block)
    if signed_block.message.state_root != state.hash_tree_root():
        raise AssertionError("block state_root mismatch")


def _h_sanity(spec, fork, handler, case: _Case) -> None:
    from ..ssz import deserialize
    from ..state_transition import process_slots
    pre = _load_state(spec, fork, case, "pre.ssz_snappy")
    if handler == "slots":
        n = case.read_yaml("slots.yaml")
        process_slots(pre, pre.slot + int(n))
        post = _load_state(spec, fork, case, "post.ssz_snappy")
        if pre.hash_tree_root() != post.hash_tree_root():
            raise AssertionError("post state root mismatch")
        return
    if handler != "blocks":
        raise _DeclaredSkip(f"sanity handler {handler} not mapped")
    meta = case.read_yaml("meta.yaml") if case.has("meta.yaml") else {}
    n_blocks = int(meta.get("blocks_count", 0))
    T = _types(spec)

    def apply_all():
        for i in range(n_blocks):
            raw = case.read_ssz(f"blocks_{i}.ssz_snappy")
            signed = deserialize(T.SignedBeaconBlock[fork].ssz_type, raw)
            _state_transition(pre, signed)

    if case.has("post.ssz_snappy"):
        apply_all()
        post = _load_state(spec, fork, case, "post.ssz_snappy")
        if pre.hash_tree_root() != post.hash_tree_root():
            raise AssertionError("post state root mismatch")
    else:
        try:
            apply_all()
        except Exception:
            # remaining block files count as consumed (case is invalid)
            for i in range(n_blocks):
                name = f"blocks_{i}.ssz_snappy"
                if case.has(name):
                    case.accessed.add(name)
            return
        raise AssertionError("invalid block chain was accepted")


def _h_bls(spec, fork, handler, case: _Case) -> None:
    from ..crypto import bls
    data = case.read_yaml("data.yaml")
    inp, expect = data["input"], data["output"]
    backend = bls.get_backend()
    if backend.name == "fake":
        # conformance needs real crypto, but never leak the switch into
        # the caller's process-global backend
        prev = backend
        backend = bls._make("python")
        assert bls.get_backend() is prev

    def hx(s):
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    if handler == "sign":
        got = backend.sign(int(inp["privkey"], 16), hx(inp["message"]))
        ok = (expect is not None and got == hx(expect))
        if expect is None:
            return                  # invalid privkey cases (not generated)
        if not ok:
            raise AssertionError("signature mismatch")
    elif handler == "verify":
        got = backend.verify(hx(inp["pubkey"]), hx(inp["message"]),
                             hx(inp["signature"]))
        if got != bool(expect):
            raise AssertionError(f"verify {got} != {expect}")
    elif handler == "aggregate":
        try:
            got = backend.aggregate_signatures([hx(s) for s in
                                                inp])
        except ValueError:
            got = None
        want = hx(expect) if expect else None
        if got != want:
            raise AssertionError("aggregate mismatch")
    elif handler == "fast_aggregate_verify":
        got = backend.fast_aggregate_verify(
            [hx(p) for p in inp["pubkeys"]], hx(inp["message"]),
            hx(inp["signature"]))
        if got != bool(expect):
            raise AssertionError(f"fast_aggregate_verify {got} != {expect}")
    elif handler == "aggregate_verify":
        got = backend.aggregate_verify(
            [hx(p) for p in inp["pubkeys"]],
            [hx(m) for m in inp["messages"]], hx(inp["signature"]))
        if got != bool(expect):
            raise AssertionError(f"aggregate_verify {got} != {expect}")
    elif handler == "eth_aggregate_pubkeys":
        pks = [hx(p) for p in inp]
        # eth spec: empty input and KeyValidate failures (infinity,
        # off-curve) reject
        if not pks or any(not backend.validate_pubkey(p) for p in pks):
            got = None
        else:
            try:
                got = backend.aggregate_public_keys(pks)
            except Exception:
                got = None
        want = hx(expect) if expect else None
        if got != want:
            raise AssertionError("eth_aggregate_pubkeys mismatch")
    elif handler == "eth_fast_aggregate_verify":
        # eth variant: empty pubkeys + infinity signature -> True
        pks = [hx(p) for p in inp["pubkeys"]]
        sig = hx(inp["signature"])
        if not pks and sig == b"\xc0" + b"\x00" * 95:
            got = True
        else:
            got = backend.fast_aggregate_verify(pks, hx(inp["message"]),
                                                sig)
        if got != bool(expect):
            raise AssertionError(
                f"eth_fast_aggregate_verify {got} != {expect}")
    else:
        raise _DeclaredSkip(f"bls handler {handler} not mapped")


def _run_fc_steps(spec, fork, case: _Case, optimistic: bool) -> None:
    """Shared fork-choice step driver (fork_choice + sync runners).

    `optimistic=True` adds the sync runner's payload-status semantics:
    blocks import with the engine-reported status of their payload
    (default SYNCING/optimistic), and on_payload_info steps propagate
    invalidation through the proto-array."""
    from ..fork_choice import ForkChoice
    from ..fork_choice.proto_array import ExecutionStatus
    from ..ssz import deserialize, htr
    T = _types(spec)
    anchor = _load_state(spec, fork, case, "anchor_state.ssz_snappy")
    anchor_blk_raw = case.read_ssz("anchor_block.ssz_snappy")
    # a genesis anchor block may carry an earlier fork's (empty) body
    anchor_block = None
    for f in [fk for fk in ForkName if fk <= fork][::-1]:
        try:
            anchor_block = deserialize(T.BeaconBlock[f].ssz_type,
                                       anchor_blk_raw)
            break
        except Exception:
            continue
    if anchor_block is None:
        raise AssertionError("anchor block undecodable")
    anchor_root = htr(anchor_block)
    fc = ForkChoice(spec, anchor_root, anchor)
    states = {anchor_root: anchor}
    payload_status: dict[bytes, str] = {}
    hash_to_root: dict[bytes, bytes] = {}      # payload hash -> block root
    current_slot = anchor.slot
    for step in case.read_yaml("steps.yaml"):
        expect_valid = bool(step.get("valid", True))
        if "tick" in step:
            # spec get_current_slot: (time - genesis_time) // spt
            current_slot = max(0, int(step["tick"]) - anchor.genesis_time) \
                // spec.seconds_per_slot
            fc.update_time(current_slot)
        elif "block" in step:
            raw = case.read_ssz(step["block"] + ".ssz_snappy")

            def apply_block():
                signed = deserialize(T.SignedBeaconBlock[fork].ssz_type,
                                     raw)
                parent = states[signed.message.parent_root].copy()
                _state_transition(parent, signed)
                root = htr(signed.message)
                es = ExecutionStatus.IRRELEVANT
                if optimistic:
                    body = signed.message.body
                    bh = body.execution_payload.block_hash \
                        if hasattr(body, "execution_payload") \
                        else b"\x00" * 32
                    hash_to_root[bh] = root
                    status = payload_status.get(bh, "SYNCING")
                    if status == "INVALID":
                        raise AssertionError("invalid payload")
                    es = ExecutionStatus.VALID if status == "VALID" \
                        else ExecutionStatus.OPTIMISTIC
                fc.on_block(current_slot, signed.message, root, parent,
                            execution_status=es)
                states[root] = parent

            _expect(apply_block, expect_valid, "block")
        elif "attestation" in step:
            raw = case.read_ssz(step["attestation"] + ".ssz_snappy")

            def apply_att():
                att = deserialize(T.Attestation.ssz_type, raw)
                from ..state_transition.helpers import (
                    get_indexed_attestation,
                )
                st = states[att.data.beacon_block_root]
                indexed = get_indexed_attestation(st, att)
                fc.on_attestation(current_slot, indexed)

            _expect(apply_att, expect_valid, "attestation")
        elif optimistic and "payload_status" in step:
            bh = bytes.fromhex(step["block_hash"][2:])
            ps = step["payload_status"]
            status = ps["status"]
            payload_status[bh] = status
            root = hash_to_root.get(bh)
            if root is not None:
                if status == "INVALID":
                    lvh = ps.get("latest_valid_hash")
                    fc.on_invalid_execution_payload(
                        root,
                        bytes.fromhex(lvh[2:]) if lvh else None)
                elif status == "VALID":
                    fc.on_valid_execution_payload(root)
        elif "checks" in step:
            checks = step["checks"]
            head = fc.get_head(current_slot)
            known = {"head", "justified_checkpoint", "finalized_checkpoint",
                     "proposer_boost_root", "time", "genesis_time"}
            unknown = set(checks) - known
            if unknown:
                raise _DeclaredSkip(f"checks {sorted(unknown)} not mapped")
            if "head" in checks:
                want = bytes.fromhex(checks["head"]["root"][2:])
                if head != want:
                    raise AssertionError(
                        f"head {head.hex()} != {want.hex()}")
            if "proposer_boost_root" in checks:
                want = bytes.fromhex(checks["proposer_boost_root"][2:])
                if fc.proposer_boost_root != want:
                    raise AssertionError("proposer_boost_root mismatch")
            for key, got in (("justified_checkpoint",
                              fc.justified_checkpoint),
                             ("finalized_checkpoint",
                              fc.finalized_checkpoint)):
                if key in checks:
                    want = checks[key]
                    if got[0] != int(want["epoch"]) or \
                            got[1] != bytes.fromhex(want["root"][2:]):
                        raise AssertionError(f"{key} mismatch")
        else:
            raise _DeclaredSkip(f"fork choice step {step} not mapped")


def _h_fork_choice(spec, fork, handler, case: _Case) -> None:
    _run_fc_steps(spec, fork, case, optimistic=False)


def _h_shuffling(spec, fork, handler, case: _Case) -> None:
    """mapping[i] == compute_shuffled_index(i, count, seed); the whole
    permutation must also match the vectorized whole-list shuffle
    (consensus/swap_or_not_shuffle parity)."""
    import numpy as np
    from ..state_transition.shuffle import (
        compute_shuffled_index, compute_shuffled_indices,
    )
    data = case.read_yaml("mapping.yaml")
    seed = bytes.fromhex(data["seed"][2:])
    count = int(data["count"])
    mapping = [int(x) for x in data["mapping"]]
    rounds = spec.preset.shuffle_round_count
    if count == 0:   # real tarballs include an empty-list case
        if mapping:
            raise AssertionError("count=0 with non-empty mapping")
        return
    for i in (0, count // 2, count - 1):
        got = compute_shuffled_index(i, count, seed, rounds)
        if got != mapping[i]:
            raise AssertionError(f"index {i}: {got} != {mapping[i]}")
    vec = compute_shuffled_indices(count, seed, rounds)
    if list(np.asarray(vec)) != mapping:
        raise AssertionError("vectorized shuffle mismatch")


def _h_kzg(spec, fork, handler, case: _Case) -> None:
    """deneb blob KZG + fulu cells cases over the devnet setup.  Real EF
    tarballs use the mainnet ceremony setup, which is not bundled
    (zero-egress image) — those suites are declared skips, not failures."""
    from ..crypto.kzg import Kzg
    if case.dir.parent.name != "kzg-devnet":
        raise _DeclaredSkip("mainnet trusted setup not bundled")
    global _KZG_DEVNET
    if _KZG_DEVNET is None:
        _KZG_DEVNET = Kzg(devnet_size=16, cells_per_ext_blob=8)
    k = _KZG_DEVNET
    data = case.read_yaml("data.yaml")
    inp, out = data["input"], data["output"]

    def hx(s):
        return bytes.fromhex(s[2:])

    if handler == "blob_to_kzg_commitment":
        got = k.blob_to_kzg_commitment(hx(inp["blob"]))
        if got != hx(out):
            raise AssertionError("commitment mismatch")
    elif handler == "verify_blob_kzg_proof":
        got = k.verify_blob_kzg_proof(hx(inp["blob"]),
                                      hx(inp["commitment"]),
                                      hx(inp["proof"]))
        if got != bool(out):
            raise AssertionError(f"verify {got} != {out}")
    elif handler == "verify_blob_kzg_proof_batch":
        got = k.verify_blob_kzg_proof_batch(
            [hx(b) for b in inp["blobs"]],
            [hx(c) for c in inp["commitments"]],
            [hx(p) for p in inp["proofs"]])
        if got != bool(out):
            raise AssertionError(f"batch verify {got} != {out}")
    elif handler == "compute_cells_and_kzg_proofs":
        cells, proofs = k.compute_cells_and_kzg_proofs(hx(inp["blob"]))
        want_cells = [hx(c) for c in out[0]]
        want_proofs = [hx(p) for p in out[1]]
        if cells != want_cells or proofs != want_proofs:
            raise AssertionError("cells/proofs mismatch")
    elif handler == "verify_cell_kzg_proof_batch":
        got = k.verify_cell_kzg_proof_batch(
            [hx(c) for c in inp["commitments"]],
            [int(i) for i in inp["cell_indices"]],
            [hx(c) for c in inp["cells"]],
            [hx(p) for p in inp["proofs"]])
        if got != bool(out):
            raise AssertionError(f"cell batch verify {got} != {out}")
    elif handler == "recover_cells_and_kzg_proofs":
        cells, proofs = k.recover_cells_and_kzg_proofs(
            [int(i) for i in inp["cell_indices"]],
            [hx(c) for c in inp["cells"]])
        if cells != [hx(c) for c in out[0]] or \
                proofs != [hx(p) for p in out[1]]:
            raise AssertionError("recovered cells/proofs mismatch")
    else:
        raise _DeclaredSkip(f"kzg handler {handler} not mapped")


_KZG_DEVNET = None


def _h_transition(spec, fork, handler, case: _Case) -> None:
    """Fork-boundary transition: apply blocks across the upgrade and
    compare the final state root (testing transition runner layout)."""
    from ..specs import minimal_spec
    from ..specs.chain_spec import FORK_ORDER
    from ..ssz import deserialize
    if spec.config_name != "minimal":
        raise _DeclaredSkip("transition vectors run on minimal only here")
    meta = case.read_yaml("meta.yaml")
    post_fork = ForkName[meta["post_fork"].upper()]
    fork_epoch = int(meta["fork_epoch"])
    overrides = {}
    for f in FORK_ORDER[1:]:           # genesis fork has no epoch knob
        if f < post_fork:
            overrides[f"{f.name.lower()}_fork_epoch"] = 0
        elif f == post_fork:
            overrides[f"{f.name.lower()}_fork_epoch"] = fork_epoch
    tspec = minimal_spec(**overrides)
    pre_fork = FORK_ORDER[FORK_ORDER.index(post_fork) - 1]
    state = _load_state(tspec, pre_fork, case, "pre.ssz_snappy")
    T = _types(tspec)
    fork_block = int(meta.get("fork_block", -1))
    for i in range(int(meta["blocks_count"])):
        raw = case.read_ssz(f"blocks_{i}.ssz_snappy")
        bfork = pre_fork if i <= fork_block else post_fork
        signed = deserialize(T.SignedBeaconBlock[bfork].ssz_type, raw)
        _state_transition(state, signed)
    post = _load_state(tspec, post_fork, case, "post.ssz_snappy")
    if state.hash_tree_root() != post.hash_tree_root():
        raise AssertionError("transition post state root mismatch")


# ---------------------------------------------------------------------------
# runners of the remaining families (no declared-skip runner is left)
# ---------------------------------------------------------------------------

def _h_finality(spec, fork, handler, case: _Case) -> None:
    """finality runner: identical case shape to sanity/blocks (the
    reference binds it to the SanityBlocks case, handler.rs:532)."""
    _h_sanity(spec, fork, "blocks", case)


def _h_random(spec, fork, handler, case: _Case) -> None:
    """random runner: sanity/blocks shape (handler.rs:421)."""
    _h_sanity(spec, fork, "blocks", case)


def _h_fork(spec, fork, handler, case: _Case) -> None:
    """Fork-upgrade runner: pre-state in the PREVIOUS fork, apply the
    in-place upgrade function, compare roots (cases/fork.rs)."""
    from ..specs.chain_spec import FORK_ORDER
    from ..state_transition import upgrades
    meta = case.read_yaml("meta.yaml")
    post_fork = ForkName[meta["fork"].upper()]
    if post_fork != fork:
        raise AssertionError(f"meta fork {post_fork} != dir fork {fork}")
    pre_fork = FORK_ORDER[FORK_ORDER.index(post_fork) - 1]
    pre = _load_state(spec, pre_fork, case, "pre.ssz_snappy")
    fn = getattr(upgrades, f"upgrade_to_{post_fork.name.lower()}")
    fn(pre)
    post = _load_state(spec, post_fork, case, "post.ssz_snappy")
    if pre.hash_tree_root() != post.hash_tree_root():
        raise AssertionError("fork upgrade post state root mismatch")


def _deltas_type():
    # NB: built via type() because this module has PEP-563 lazy
    # annotations — a class-body annotation would reach @container as a
    # string, not an SSZType
    from ..ssz import List, container, uint64
    return container(type("Deltas", (), {"__annotations__": dict(
        rewards=List(uint64, 1 << 40),
        penalties=List(uint64, 1 << 40))}))


def _h_rewards(spec, fork, handler, case: _Case) -> None:
    """Per-component reward/penalty deltas (cases/rewards.rs): compare
    our vectorized delta computation to the vectors, component-wise."""
    import numpy as np
    from ..ssz import deserialize
    from ..state_transition import epoch as ep
    from ..state_transition.helpers import get_total_active_balance
    Deltas = _deltas_type()
    pre = _load_state(spec, fork, case, "pre.ssz_snappy")
    total = get_total_active_balance(pre)

    def check(name: str, rewards: np.ndarray, penalties: np.ndarray):
        want = deserialize(Deltas.ssz_type,
                           case.read_ssz(f"{name}.ssz_snappy"))
        if list(want.rewards) != [int(x) for x in rewards] or \
                list(want.penalties) != [int(x) for x in penalties]:
            raise AssertionError(f"{name} deltas mismatch")

    if fork == ForkName.PHASE0:
        comp = ep.phase0_reward_deltas(pre, total)
        check("source_deltas", *comp["source"])
        check("target_deltas", *comp["target"])
        check("head_deltas", *comp["head"])
        check("inclusion_delay_deltas", *comp["inclusion_delay"])
        check("inactivity_penalty_deltas", *comp["inactivity"])
    else:
        from ..specs.constants import (
            TIMELY_HEAD_FLAG_INDEX, TIMELY_SOURCE_FLAG_INDEX,
            TIMELY_TARGET_FLAG_INDEX,
        )
        for name, idx in (("source_deltas", TIMELY_SOURCE_FLAG_INDEX),
                          ("target_deltas", TIMELY_TARGET_FLAG_INDEX),
                          ("head_deltas", TIMELY_HEAD_FLAG_INDEX)):
            check(name, *ep.altair_flag_deltas(pre, total, idx))
        check("inactivity_penalty_deltas",
              *ep.altair_inactivity_deltas(pre, pre.fork_name))


def _h_genesis(spec, fork, handler, case: _Case) -> None:
    from ..specs import minimal_spec
    from ..ssz import deserialize
    from ..state_transition import genesis as gen
    T = _types(spec)
    if handler == "validity":
        state = _load_state(spec, fork, case, "genesis.ssz_snappy")
        want = bool(case.read_yaml("is_valid.yaml"))
        got = gen.is_valid_genesis_state(state)
        if got != want:
            raise AssertionError(f"genesis validity {got} != {want}")
        return
    if handler != "initialization":
        raise _DeclaredSkip(f"genesis handler {handler} not mapped")
    if spec.config_name != "minimal":
        raise _DeclaredSkip("genesis initialization runs on minimal only")
    # genesis lands at the case's fork: pin every fork <= it to epoch 0
    # (initialize_beacon_state_from_eth1 derives the genesis fork from
    # the spec, matching the reference's all-fork genesis support)
    tspec = minimal_spec(**{
        f"{f.name.lower()}_fork_epoch": 0
        for f in ForkName if ForkName.PHASE0 < f <= fork})
    eth1 = case.read_yaml("eth1.yaml")
    meta = case.read_yaml("meta.yaml")
    deposits = [deserialize(T.Deposit.ssz_type,
                            case.read_ssz(f"deposits_{i}.ssz_snappy"))
                for i in range(int(meta["deposits_count"]))]
    header = None
    if case.has("execution_payload_header.ssz_snappy"):
        header = deserialize(
            T.ExecutionPayloadHeader[fork].ssz_type,
            case.read_ssz("execution_payload_header.ssz_snappy"))
    state = gen.initialize_beacon_state_from_eth1(
        tspec, bytes.fromhex(eth1["eth1_block_hash"][2:]),
        int(eth1["eth1_timestamp"]), deposits,
        execution_payload_header=header)
    want = _load_state(tspec, fork, case, "state.ssz_snappy")
    if state.hash_tree_root() != want.hash_tree_root():
        raise AssertionError("genesis state root mismatch")


# ssz_generic: case names encode the type (spec-tests layout)

def _ssz_generic_type(handler: str, case_name: str):
    from ..ssz import (
        Bitlist, Bitvector, Boolean, List, UInt, Vector, container, uint8,
        uint16, uint32, uint64, uint128, uint256,
    )
    uints = {8: uint8, 16: uint16, 32: uint32, 64: uint64, 128: uint128,
             256: uint256}
    parts = case_name.split("_")
    if handler == "boolean":
        return Boolean()
    if handler == "uints":
        return uints[int(parts[1])]
    if handler == "basic_vector":
        # vec_{elemtype}_{length}_...
        elem = Boolean() if parts[1] == "bool" else \
            uints[int(parts[1].removeprefix("uint"))]
        return Vector(elem, int(parts[2]))
    if handler == "bitvector":
        return Bitvector(int(parts[1]))
    if handler == "bitlist":
        if parts[1] == "no":          # bitlist_no_delimiter_*
            return Bitlist(64)
        return Bitlist(int(parts[1]))
    if handler == "containers":
        return _ssz_generic_container(parts[0])
    raise _DeclaredSkip(f"ssz_generic handler {handler} not mapped")


def _ssz_generic_container(name: str):
    """The spec-tests container zoo (ssz_generic/containers).  Built via
    type() — see _deltas_type's PEP-563 note."""
    from ..ssz import (
        Bitlist, Bitvector, List, Vector, container, uint8, uint16,
        uint32, uint64,
    )

    def mk(cls_name, **fields):
        return container(type(cls_name, (),
                              {"__annotations__": fields}))

    SingleFieldTestStruct = mk("SingleFieldTestStruct", A=uint8)
    SmallTestStruct = mk("SmallTestStruct", A=uint16, B=uint16)
    FixedTestStruct = mk("FixedTestStruct", A=uint8, B=uint64, C=uint32)
    VarTestStruct = mk("VarTestStruct", A=uint16, B=List(uint16, 1024),
                       C=uint8)
    ComplexTestStruct = mk(
        "ComplexTestStruct", A=uint16, B=List(uint16, 128), C=uint8,
        D=List(uint8, 256), E=VarTestStruct.ssz_type,
        F=Vector(FixedTestStruct.ssz_type, 4),
        G=Vector(VarTestStruct.ssz_type, 2))
    BitsStruct = mk("BitsStruct", A=Bitlist(5), B=Bitvector(2),
                    C=Bitvector(1), D=Bitlist(6), E=Bitvector(8))

    zoo = {c.__name__: c for c in (
        SingleFieldTestStruct, SmallTestStruct, FixedTestStruct,
        VarTestStruct, ComplexTestStruct, BitsStruct)}
    cls = zoo.get(name)
    if cls is None:
        raise _DeclaredSkip(f"ssz_generic container {name} not mapped")
    return cls.ssz_type


def _h_ssz_generic(spec, fork, handler, case: _Case) -> None:
    from ..ssz import deserialize, serialize
    from ..ssz.codec import DeserializeError
    from ..ssz.merkle import hash_tree_root
    suite = case.dir.parent.name        # "valid" | "invalid"
    raw = case.read_ssz("serialized.ssz_snappy")
    if suite == "invalid":
        try:
            # zero-length Vector/Bitvector etc. are invalid TYPES: a
            # construction-time rejection counts as rejecting the case
            typ = _ssz_generic_type(handler, case.dir.name)
            deserialize(typ, raw)
        except (DeserializeError, ValueError, IndexError, AssertionError):
            return
        raise AssertionError("invalid ssz_generic case was accepted")
    typ = _ssz_generic_type(handler, case.dir.name)
    meta = case.read_yaml("meta.yaml")
    if case.has("value.yaml"):
        case.read("value.yaml")         # structure covered by the root
    obj = deserialize(typ, raw)
    if serialize(typ, obj) != raw:
        raise AssertionError("ssz_generic roundtrip mismatch")
    got = "0x" + hash_tree_root(typ, obj).hex()
    if got != meta["root"]:
        raise AssertionError(f"root {got} != {meta['root']}")


def _h_merkle_proof(spec, fork, handler, case: _Case) -> None:
    """single_merkle_proof (incl. the deneb KZG-commitment inclusion
    proof): recompute the branch root bottom-up with plain hashing and
    compare against the object's hash tree root (cases/
    merkle_proof_validity.rs + kzg inclusion variant)."""
    from ..ssz import deserialize, htr
    from ..ssz.merkle_proof import merkle_root_from_branch
    proof = case.read_yaml("proof.yaml")
    leaf = bytes.fromhex(proof["leaf"][2:])
    gindex = int(proof["leaf_index"])
    branch = [bytes.fromhex(b[2:]) for b in proof["branch"]]
    obj_name = case.dir.parent.name
    T = _types(spec)
    if obj_name == "BeaconState":
        root = _load_state(spec, fork, case,
                           "object.ssz_snappy").hash_tree_root()
    elif obj_name == "BeaconBlockBody":
        obj = deserialize(T.BeaconBlockBody[fork].ssz_type,
                          case.read_ssz("object.ssz_snappy"))
        root = htr(obj)
    else:
        raise _DeclaredSkip(f"merkle_proof object {obj_name}")
    got = merkle_root_from_branch(leaf, branch, gindex)
    if got != root:
        raise AssertionError(
            f"merkle proof root {got.hex()} != {root.hex()}")


def _h_light_client(spec, fork, handler, case: _Case) -> None:
    """light_client/single_merkle_proof — the case shape the reference
    binds (handler.rs:799; sync/update-ranking protocol cases are not
    reference case types)."""
    if handler != "single_merkle_proof":
        raise _DeclaredSkip(f"light_client handler {handler} not mapped")
    _h_merkle_proof(spec, fork, handler, case)


def _h_sync(spec, fork, handler, case: _Case) -> None:
    """sync/optimistic: fork-choice steps + engine payload-status
    injections (on_payload_info), driving optimistic import and
    invalidation through the proto-array."""
    _run_fc_steps(spec, fork, case, optimistic=True)


_HANDLERS = {
    "ssz_static": _h_ssz_static,
    "operations": _h_operations,
    "epoch_processing": _h_epoch_processing,
    "sanity": _h_sanity,
    "bls": _h_bls,
    "fork_choice": _h_fork_choice,
    "shuffling": _h_shuffling,
    "kzg": _h_kzg,
    "transition": _h_transition,
    "finality": _h_finality,
    "random": _h_random,
    "fork": _h_fork,
    "rewards": _h_rewards,
    "genesis": _h_genesis,
    "ssz_generic": _h_ssz_generic,
    "merkle_proof": _h_merkle_proof,
    "light_client": _h_light_client,
    "sync": _h_sync,
}
