"""Priority work scheduler.

Equivalent of the reference's beacon_node/beacon_processor (src/lib.rs:
552-612 Work enum, :758 spawn_manager, work_reprocessing_queue.rs): a
manager drains typed queues in strict priority order into a bounded worker
pool; early-arriving work is parked and replayed; gossip attestations are
opportunistically drained into batches (the card's batch-verify feeder).
"""
from .processor import BeaconProcessor, Work, WorkType
from .reprocess import ReprocessQueue
