"""Networking (L7).

Equivalent of the reference's beacon_node/{lighthouse_network,network}
(61k LoC incl. vendored gossipsub), rebuilt compactly:

- ``transport``: length-prefixed framed TCP with handshake (the libp2p
  TCP+noise+yamux stack's role)
- ``gossip``: flood-publish pubsub with message-id dedup and validation
  hooks (gossipsub mesh management TODO; topics match types/topics.rs:109)
- ``rpc``: status/goodbye/ping/metadata/blocks_by_range/blocks_by_root with
  zlib-compressed SSZ payloads (SSZ-snappy's role, rpc/protocol.rs:236-266)
- ``peer_manager``: scoring + ban thresholds (peer_manager/peerdb/score.rs)
- ``service``: NetworkService wiring gossip/rpc to the chain + processor
  (network/src/{service,router}.rs)
- ``sync``: range sync + block lookups (network/src/sync/manager.rs)
"""
from .transport import Transport, Peer
from .gossip import GossipEngine, Topic
from .rpc import RpcHandler, StatusMessage
from .peer_manager import PeerManager
from .service import NetworkService, NetworkConfig
from .sync import SyncManager
