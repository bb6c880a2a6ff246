"""Eth1 deposit-contract chain tracker (L6 sidecar).

Equivalent of the reference's beacon_node/eth1 (3.7k LoC): a polling service
over an eth1 data source maintaining a block cache and a deposit cache
(incremental merkle tree), serving (a) `eth1_data` votes for block
production (follow-distance + voting-period majority) and (b) `Deposit`s
with proofs for inclusion once `state.eth1_data.deposit_count` exceeds
`state.eth1_deposit_index`.
"""
from .service import Eth1Service, Eth1Block, MockEth1Endpoint, DepositLog
