"""Beacon chain core (L4).

Equivalent of the reference's beacon_node/beacon_chain (53.8k LoC): the
BeaconChain service with its verification pipelines, canonical head,
observation caches, block production, and the test harness.
"""
from .beacon_chain import BeaconChain, ChainConfig
from .builder import BeaconChainBuilder
from .errors import BlockError, AttestationError, ChainError
from .harness import BeaconChainHarness
