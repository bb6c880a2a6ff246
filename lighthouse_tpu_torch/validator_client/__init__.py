"""Validator client (the parallel stack, SURVEY.md VC row).

Equivalent of the reference's validator_client (23.1k LoC): per-slot duty
machine — duties polling, block proposal, attestation + aggregation,
sync-committee duty, preparation — over a `ValidatorStore` signing facade
gated by SQLite slashing protection (EIP-3076), with multi-BN failover.
"""
from .slashing_protection import SlashingDatabase, SlashingError
from .validator_store import ValidatorStore
from .client import ValidatorClient, BeaconNodeInterface
from .fallback import BeaconNodeFallback
from .http_client import BeaconNodeHttpClient
from .byzantine import ByzantineValidatorClient
