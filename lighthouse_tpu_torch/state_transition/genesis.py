"""Genesis state construction.

Equivalent of the reference's consensus/state_processing/src/genesis.rs and
beacon_node/genesis (interop genesis: testing via deterministic keypairs,
genesis/src/interop.rs:31,54).
"""
from __future__ import annotations

import numpy as np

from ..containers.state import BeaconState
from ..crypto import bls
from ..specs.chain_spec import ChainSpec, ForkName, compute_domain, \
    compute_signing_root
from ..specs.constants import (
    DEPOSIT_CONTRACT_TREE_DEPTH, DOMAIN_DEPOSIT, FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
)
from ..ssz import htr, mix_in_length
from ..ssz.merkle_proof import MerkleTree
from ..containers import get_types
from .block import apply_deposit
from .helpers import get_active_validator_indices


def initialize_beacon_state_from_eth1(spec: ChainSpec,
                                      eth1_block_hash: bytes,
                                      eth1_timestamp: int,
                                      deposits: list,
                                      execution_payload_header=None
                                      ) -> BeaconState:
    """Spec initialize_beacon_state_from_eth1, with in-place deposit-tree
    root updates per deposit (genesis.rs)."""
    T = get_types(spec.preset)
    fork = ForkName.PHASE0
    state = BeaconState(T, spec, fork)
    state.genesis_time = eth1_timestamp + spec.genesis_delay
    state.fork = T.Fork(previous_version=spec.genesis_fork_version,
                        current_version=spec.genesis_fork_version,
                        epoch=GENESIS_EPOCH)
    state.eth1_data = T.Eth1Data(deposit_root=b"\x00" * 32,
                                 deposit_count=len(deposits),
                                 block_hash=eth1_block_hash)
    body = T.BeaconBlockBody[fork]()
    state.latest_block_header = T.BeaconBlockHeader(body_root=htr(body))
    state.randao_mixes = np.tile(
        np.frombuffer(eth1_block_hash, np.uint8),
        (T.preset.epochs_per_historical_vector, 1))

    # incremental deposit tree for progressive roots
    tree = MerkleTree(DEPOSIT_CONTRACT_TREE_DEPTH)
    for deposit in deposits:
        tree.push_leaf(htr(deposit.data))
        state.eth1_data.deposit_root = mix_in_length(tree.hash(), len(tree))
        # apply without the proof check (we just built the tree)
        state.eth1_deposit_index += 1
        apply_deposit(state, deposit.data.pubkey,
                      deposit.data.withdrawal_credentials,
                      deposit.data.amount, deposit.data.signature)

    # activate genesis validators
    p = T.preset
    v = state.validators
    for i in range(len(v)):
        eff = min(int(state.balances[i])
                  - int(state.balances[i]) % p.effective_balance_increment,
                  p.max_effective_balance)
        v.set_field(i, "effective_balance", eff)
        if eff == p.max_effective_balance:
            v.set_field(i, "activation_eligibility_epoch", GENESIS_EPOCH)
            v.set_field(i, "activation_epoch", GENESIS_EPOCH)
    state.genesis_validators_root = v.hash_tree_root(
        p.validator_registry_limit)

    # genesis at a later fork (reference supports all-fork genesis)
    from . import upgrades
    genesis_fork = spec.fork_name_at_epoch(GENESIS_EPOCH)
    chain = [(ForkName.ALTAIR, upgrades.upgrade_to_altair),
             (ForkName.BELLATRIX, upgrades.upgrade_to_bellatrix),
             (ForkName.CAPELLA, upgrades.upgrade_to_capella),
             (ForkName.DENEB, upgrades.upgrade_to_deneb),
             (ForkName.ELECTRA, upgrades.upgrade_to_electra)]
    for f, fn in chain:
        if genesis_fork >= f:
            fn(state)
            # upgrades set fork.previous_version; genesis forks collapse
            state.fork = T.Fork(
                previous_version=spec.fork_version(f),
                current_version=spec.fork_version(f), epoch=GENESIS_EPOCH)
    if execution_payload_header is not None and \
            genesis_fork >= ForkName.BELLATRIX:
        state.latest_execution_payload_header = execution_payload_header
    return state


def is_valid_genesis_state(state: BeaconState) -> bool:
    spec = state.spec
    if state.genesis_time < spec.min_genesis_time:
        return False
    return len(get_active_validator_indices(state, GENESIS_EPOCH)) >= \
        spec.min_genesis_active_validator_count


def genesis_deposits(spec: ChainSpec, secret_keys: list[int],
                     amount: int | None = None) -> list:
    """Build valid deposits (with proofs) for the given keys
    (testing/eth2_interop_keypairs equivalent)."""
    T = get_types(spec.preset)
    amount = amount or T.preset.max_effective_balance
    domain = compute_domain(DOMAIN_DEPOSIT, spec.genesis_fork_version,
                            b"\x00" * 32)
    datas = []
    for sk in secret_keys:
        pk = bls.sk_to_pk(sk)
        import hashlib
        wc = b"\x00" + hashlib.sha256(pk).digest()[1:]
        msg = T.DepositMessage(pubkey=pk, withdrawal_credentials=wc,
                               amount=amount)
        sig = bls.sign(sk, compute_signing_root(htr(msg), domain))
        datas.append(T.DepositData(pubkey=pk, withdrawal_credentials=wc,
                                   amount=amount, signature=sig))
    tree = MerkleTree(DEPOSIT_CONTRACT_TREE_DEPTH)
    for d in datas:
        tree.push_leaf(htr(d))
    deposits = []
    for i, d in enumerate(datas):
        proof = tree.generate_proof(i) + [
            len(datas).to_bytes(32, "little")]
        deposits.append(T.Deposit(proof=proof, data=d))
    return deposits


def interop_genesis_state(spec: ChainSpec, secret_keys: list[int],
                          genesis_time: int | None = None,
                          eth1_block_hash: bytes = b"\x42" * 32
                          ) -> BeaconState:
    """Deterministic-keypair genesis (genesis/src/interop.rs:31)."""
    deposits = genesis_deposits(spec, secret_keys)
    state = initialize_beacon_state_from_eth1(
        spec, eth1_block_hash, eth1_timestamp=spec.min_genesis_time,
        deposits=deposits)
    if genesis_time is not None:
        state.genesis_time = genesis_time
    return state
