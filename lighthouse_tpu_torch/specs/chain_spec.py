"""Runtime chain configuration (config.yaml equivalent) + fork schedule.

Reference: consensus/types/src/chain_spec.rs (runtime YAML config) and the
fork-version/epoch schedule selection in common/eth2_network_config.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields

from ..utils.hash import hash_concat, sha256
from .constants import FAR_FUTURE_EPOCH
from .presets import MAINNET_PRESET, MINIMAL_PRESET, Preset


class ForkName(enum.IntEnum):
    PHASE0 = 0
    ALTAIR = 1
    BELLATRIX = 2
    CAPELLA = 3
    DENEB = 4
    ELECTRA = 5

    @property
    def previous(self) -> "ForkName":
        return ForkName(max(0, self.value - 1))

    @property
    def next(self) -> "ForkName | None":
        return ForkName(self.value + 1) if self.value + 1 < len(ForkName) else None


FORK_ORDER = list(ForkName)


@dataclass
class ChainSpec:
    preset: Preset
    config_name: str = "devnet"

    # Genesis
    min_genesis_active_validator_count: int = 16384
    min_genesis_time: int = 0
    genesis_delay: int = 604800
    genesis_fork_version: bytes = b"\x00\x00\x00\x00"

    # Fork schedule: version (4 bytes) + activation epoch per fork
    altair_fork_version: bytes = b"\x01\x00\x00\x00"
    altair_fork_epoch: int = FAR_FUTURE_EPOCH
    bellatrix_fork_version: bytes = b"\x02\x00\x00\x00"
    bellatrix_fork_epoch: int = FAR_FUTURE_EPOCH
    capella_fork_version: bytes = b"\x03\x00\x00\x00"
    capella_fork_epoch: int = FAR_FUTURE_EPOCH
    deneb_fork_version: bytes = b"\x04\x00\x00\x00"
    deneb_fork_epoch: int = FAR_FUTURE_EPOCH
    electra_fork_version: bytes = b"\x05\x00\x00\x00"
    electra_fork_epoch: int = FAR_FUTURE_EPOCH

    # Time parameters
    seconds_per_slot: int = 12
    seconds_per_eth1_block: int = 14
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    eth1_follow_distance: int = 2048

    # Validator cycle
    ejection_balance: int = 16 * 10**9
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536
    max_per_epoch_activation_churn_limit: int = 8
    # Electra churn (Gwei-denominated)
    min_per_epoch_churn_limit_electra: int = 128 * 10**9
    max_per_epoch_activation_exit_churn_limit: int = 256 * 10**9

    # Fork choice
    proposer_score_boost: int = 40
    reorg_head_weight_threshold: int = 20
    reorg_parent_weight_threshold: int = 160
    reorg_max_epochs_since_finalization: int = 2

    # Deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = b"\x00" * 20

    # Networking (subset used by gossip/rpc layers)
    gossip_max_size: int = 10 * 2**20
    max_request_blocks: int = 1024
    max_request_blob_sidecars: int = 768
    min_epochs_for_block_requests: int = 33024
    min_epochs_for_blob_sidecars_requests: int = 4096
    ttfb_timeout: int = 5
    resp_timeout: int = 10
    attestation_propagation_slot_range: int = 32
    maximum_gossip_clock_disparity_ms: int = 500
    subnets_per_node: int = 2
    epochs_per_subnet_subscription: int = 256
    attestation_subnet_extra_bits: int = 0
    attestation_subnet_prefix_bits: int = 6

    # Custom extras
    terminal_total_difficulty: int = 2**256 - 2**10
    terminal_block_hash: bytes = b"\x00" * 32
    terminal_block_hash_activation_epoch: int = FAR_FUTURE_EPOCH

    # ------------------------------------------------------------------
    def fork_name_at_epoch(self, epoch: int) -> ForkName:
        if epoch >= self.electra_fork_epoch:
            return ForkName.ELECTRA
        if epoch >= self.deneb_fork_epoch:
            return ForkName.DENEB
        if epoch >= self.capella_fork_epoch:
            return ForkName.CAPELLA
        if epoch >= self.bellatrix_fork_epoch:
            return ForkName.BELLATRIX
        if epoch >= self.altair_fork_epoch:
            return ForkName.ALTAIR
        return ForkName.PHASE0

    def fork_name_at_slot(self, slot: int) -> ForkName:
        return self.fork_name_at_epoch(slot // self.preset.slots_per_epoch)

    def fork_version(self, fork: ForkName) -> bytes:
        return {
            ForkName.PHASE0: self.genesis_fork_version,
            ForkName.ALTAIR: self.altair_fork_version,
            ForkName.BELLATRIX: self.bellatrix_fork_version,
            ForkName.CAPELLA: self.capella_fork_version,
            ForkName.DENEB: self.deneb_fork_version,
            ForkName.ELECTRA: self.electra_fork_version,
        }[fork]

    def fork_epoch(self, fork: ForkName) -> int:
        return {
            ForkName.PHASE0: 0,
            ForkName.ALTAIR: self.altair_fork_epoch,
            ForkName.BELLATRIX: self.bellatrix_fork_epoch,
            ForkName.CAPELLA: self.capella_fork_epoch,
            ForkName.DENEB: self.deneb_fork_epoch,
            ForkName.ELECTRA: self.electra_fork_epoch,
        }[fork]

    def slot_duration(self) -> float:
        return float(self.seconds_per_slot)

    # -- churn ---------------------------------------------------------
    def churn_limit(self, active_validator_count: int) -> int:
        return max(self.min_per_epoch_churn_limit,
                   active_validator_count // self.churn_limit_quotient)

    def activation_churn_limit(self, active_validator_count: int) -> int:
        """Deneb caps the activation churn (EIP-7514)."""
        return min(self.max_per_epoch_activation_churn_limit,
                   self.churn_limit(active_validator_count))

    def balance_churn_limit(self, total_active_balance: int) -> int:
        """Electra per-epoch churn in Gwei (get_balance_churn_limit)."""
        churn = max(self.min_per_epoch_churn_limit_electra,
                    total_active_balance // self.churn_limit_quotient)
        return churn - churn % self.preset.effective_balance_increment

    def to_dict(self) -> dict:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, bytes):
                v = "0x" + v.hex()
            elif isinstance(v, Preset):
                v = v.name
            out[f.name] = v
        return out


def mainnet_spec() -> ChainSpec:
    return ChainSpec(
        preset=MAINNET_PRESET,
        config_name="mainnet",
        min_genesis_time=1606824000,
        genesis_fork_version=b"\x00\x00\x00\x00",
        altair_fork_version=b"\x01\x00\x00\x00", altair_fork_epoch=74240,
        bellatrix_fork_version=b"\x02\x00\x00\x00", bellatrix_fork_epoch=144896,
        capella_fork_version=b"\x03\x00\x00\x00", capella_fork_epoch=194048,
        deneb_fork_version=b"\x04\x00\x00\x00", deneb_fork_epoch=269568,
        deposit_chain_id=1, deposit_network_id=1,
    )


def minimal_spec(**overrides) -> ChainSpec:
    kw = dict(
        preset=MINIMAL_PRESET,
        config_name="minimal",
        min_genesis_active_validator_count=64,
        genesis_delay=300,
        seconds_per_slot=6,
        eth1_follow_distance=16,
        min_validator_withdrawability_delay=256,
        shard_committee_period=64,
        churn_limit_quotient=32,
        min_per_epoch_churn_limit=2,
        max_per_epoch_activation_churn_limit=4,
        min_per_epoch_churn_limit_electra=64 * 10**9,
        max_per_epoch_activation_exit_churn_limit=128 * 10**9,
        genesis_fork_version=b"\x00\x00\x00\x01",
        altair_fork_version=b"\x01\x00\x00\x01",
        bellatrix_fork_version=b"\x02\x00\x00\x01",
        capella_fork_version=b"\x03\x00\x00\x01",
        deneb_fork_version=b"\x04\x00\x00\x01",
        electra_fork_version=b"\x05\x00\x00\x01",
    )
    kw.update(overrides)
    return ChainSpec(**kw)


# ---------------------------------------------------------------------------
# Signing domains (spec helpers; ForkData/SigningData roots computed inline
# to keep specs independent of the containers package)
# ---------------------------------------------------------------------------

def compute_fork_data_root(current_version: bytes,
                           genesis_validators_root: bytes) -> bytes:
    """hash_tree_root(ForkData) — 2-field container of Bytes4 + Bytes32."""
    return hash_concat(current_version.ljust(32, b"\x00"),
                       genesis_validators_root)


def compute_fork_digest(current_version: bytes,
                        genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(domain_type: int, fork_version: bytes,
                   genesis_validators_root: bytes) -> bytes:
    fork_data_root = compute_fork_data_root(fork_version,
                                            genesis_validators_root)
    return domain_type.to_bytes(4, "little") + fork_data_root[:28]


def compute_signing_root(object_root: bytes, domain: bytes) -> bytes:
    """hash_tree_root(SigningData{object_root, domain})."""
    return hash_concat(object_root, domain)


def get_domain(spec: ChainSpec, domain_type: int, epoch: int,
               fork_current_version: bytes, fork_previous_version: bytes,
               fork_epoch: int, genesis_validators_root: bytes) -> bytes:
    version = (fork_previous_version if epoch < fork_epoch
               else fork_current_version)
    return compute_domain(domain_type, version, genesis_validators_root)
