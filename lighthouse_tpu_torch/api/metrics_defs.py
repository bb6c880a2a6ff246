"""Metric catalog — the names the rest of the node instruments against.

Equivalent in role to lighthouse's beacon_chain/src/metrics.rs: one
place declaring every metric name + help string, so dashboards can rely
on a stable inventory.  The generic registry machinery lives in
metrics.py; this module pre-registers the catalog and offers typed
helpers.

The catalog is the JAX package's, name for name, except the runtime
accounting entries: where the JAX package counts XLA compiles, its
persistent compile cache and jax transfers, the port counts its nvcc
kernel builds, the ``_build/`` library cache and its own host<->device
copies (``obs/cuda_accounting``). ``PORT_NAMES`` maps each JAX name to
the port's.
"""
from __future__ import annotations

from . import metrics

#: name -> (kind, help)
CATALOG: dict[str, tuple[str, str]] = {
    # -- block import pipeline (beacon_chain.rs BLOCK_PROCESSING_*) ------
    "beacon_block_processing_seconds":
        ("hist", "Full process_block latency"),
    "beacon_block_processing_gossip_verification_seconds":
        ("hist", "verify_block_for_gossip latency"),
    "beacon_block_processing_signature_seconds":
        ("hist", "Batch signature verification latency"),
    "beacon_block_processing_state_transition_seconds":
        ("hist", "per_block_processing + slot advance latency"),
    "beacon_block_processing_state_root_seconds":
        ("hist", "tree_hash_root of the post state"),
    "beacon_block_processing_fork_choice_seconds":
        ("hist", "fork_choice.on_block latency"),
    "beacon_block_processing_db_write_seconds":
        ("hist", "Block + state persistence latency"),
    "beacon_block_imported_total":
        ("counter", "Blocks imported"),
    "beacon_block_production_seconds":
        ("hist", "produce_block latency"),
    "beacon_block_production_total": ("counter", "Blocks produced"),
    "beacon_reorgs_total": ("counter", "Head reorganizations"),
    "beacon_head_slot": ("gauge", "Canonical head slot"),
    "beacon_finalized_epoch": ("gauge", "Finalized epoch"),
    "beacon_justified_epoch": ("gauge", "Justified epoch"),
    "beacon_head_state_validators_total":
        ("gauge", "Validator count in the head state"),
    # -- attestation pipeline -------------------------------------------
    "beacon_attestation_processing_seconds":
        ("hist", "Unaggregated attestation verification latency"),
    "beacon_aggregate_processing_seconds":
        ("hist", "Aggregate verification latency"),
    "beacon_attestations_imported_total":
        ("counter", "Attestations applied to fork choice"),
    "beacon_attestations_invalid_total":
        ("counter", "Attestations rejected"),
    "beacon_batch_verify_signature_sets":
        ("hist", "Signature sets per BLS batch call"),
    "beacon_batch_verify_seconds":
        ("hist", "verify_signature_sets latency"),
    # -- gossip plane (lighthouse_network metrics) ----------------------
    "gossipsub_messages_received_total":
        ("counter", "Gossip data messages received"),
    "gossipsub_messages_published_total":
        ("counter", "Gossip data messages published"),
    "gossipsub_duplicates_dropped_total":
        ("counter", "Seen-cache duplicate drops"),
    "gossipsub_validation_accept_total":
        ("counter", "Gossip accepted"),
    "gossipsub_validation_ignore_total":
        ("counter", "Gossip ignored"),
    "gossipsub_validation_reject_total":
        ("counter", "Gossip rejected"),
    "gossipsub_mesh_peers": ("gauge", "Mesh size across topics"),
    "gossipsub_publish_seconds":
        ("hist", "Block publish fan-out latency (gossip_publish span; "
                 "carries the eth2 content-derived message_id)"),
    "gossipsub_deliver_seconds":
        ("hist", "Aggregate delivery-callback latency (gossip_deliver "
                 "span; block deliveries are traced by the "
                 "block_pipeline span instead)"),
    "rpc_request_seconds":
        ("hist", "Req/resp requester-side round-trip (rpc_request span, "
                 "content-derived req_id shared with the responder)"),
    "rpc_serve_seconds":
        ("hist", "Req/resp responder-side handler latency (rpc_serve "
                 "span, same content-derived req_id)"),
    # -- graftpath propagation + stage occupancy (obs/causal.py) ----------
    "block_propagation_seconds":
        ("hist", "Block publish -> import on a receiving node (stitched "
                 "by block root across the in-process network)"),
    "attestation_propagation_seconds":
        ("hist", "Aggregate publish -> delivery on a receiving node "
                 "(stitched by gossip message-id)"),
    "import_stage_busy_fraction_signature":
        ("gauge", "Fraction of the last slot spent in batch signature "
                  "verification (obs/occupancy.py)"),
    "import_stage_busy_fraction_state_transition":
        ("gauge", "Fraction of the last slot spent in per-block state "
                  "transition"),
    "import_stage_busy_fraction_merkleization":
        ("gauge", "Fraction of the last slot spent computing post-state "
                  "roots"),
    "import_stage_busy_fraction_persistence":
        ("gauge", "Fraction of the last slot spent persisting blocks and "
                  "states"),
    "gossipsub_idontwant_sent_total":
        ("counter", "IDONTWANT control messages sent"),
    "libp2p_peers": ("gauge", "Connected libp2p peers"),
    "libp2p_peer_connect_total": ("counter", "Peer connections"),
    "libp2p_peer_disconnect_total": ("counter", "Peer disconnects"),
    "libp2p_rpc_requests_total": ("counter", "Req/resp requests served"),
    "libp2p_rpc_errors_total": ("counter", "Req/resp error responses"),
    # -- sync (network/src/sync metrics) --------------------------------
    "sync_range_batches_downloaded_total":
        ("counter", "Range-sync batches downloaded"),
    "sync_range_blocks_imported_total":
        ("counter", "Blocks imported by range sync"),
    "sync_backfill_batches_total":
        ("counter", "Backfill batches processed"),
    "sync_parent_lookups_total": ("counter", "Parent-root lookups"),
    "sync_state": ("gauge", "0 synced / 1 range-syncing"),
    "sync_penalties_total":
        ("counter", "Sync-path peer penalties (per-reason counters are "
                    "exposed as sync_penalties_total_<reason>)"),
    "sync_request_deadline_expired_total":
        ("counter", "Sync requests individually failed by their own "
                    "deadline (per-request wheel, not a global stall)"),
    "sync_pump_global_stall_total":
        ("counter", "Pump passes that failed every in-flight request at "
                    "once — structurally zero since the per-request "
                    "deadline wheel; kept as a tripwire"),
    "sync_batch_validation_rejects_total":
        ("counter", "Range/backfill batches rejected by download-time "
                    "validation before reaching process_segment"),
    "sync_peer_quarantined_total":
        ("counter", "Peers quarantined by sync backoff after repeated "
                    "request failures"),
    # -- beacon processor (beacon_processor/src/metrics) ----------------
    "beacon_processor_work_events_total":
        ("counter", "Work items submitted"),
    "beacon_processor_workers_active": ("gauge", "Busy workers"),
    "beacon_processor_queue_length": ("gauge", "Pending work items"),
    "beacon_processor_reprocess_total":
        ("counter", "Requeued early-arriving work"),
    "beacon_processor_work_dropped_total":
        ("counter", "Work items shed at queue capacity (oldest-first)"),
    "beacon_batch_verify_fallback_total":
        ("counter", "Batch signature verifications split into per-item "
                    "retries after a failed multi-set check"),
    "vc_http_retries_total":
        ("counter", "Validator-client HTTP requests retried after a "
                    "connection-level failure"),
    # -- op pool ---------------------------------------------------------
    "op_pool_attestations": ("gauge", "Attestations pooled"),
    "op_pool_slashings": ("gauge", "Slashings pooled"),
    "op_pool_exits": ("gauge", "Voluntary exits pooled"),
    # -- shared shuffling cache (state_transition/helpers.py) -----------
    "shuffle_cache_hits_total":
        ("counter", "Shared (seed, epoch) shuffling-cache hits"),
    "shuffle_cache_misses_total":
        ("counter", "Shared shuffling-cache misses (full re-shuffle)"),
    # -- store ------------------------------------------------------------
    "store_hot_db_ops_total": ("counter", "Hot DB operations"),
    "store_cold_db_ops_total": ("counter", "Freezer operations"),
    "store_migration_seconds": ("hist", "migrate_database latency"),
    "store_cold_state_replay_seconds":
        ("hist", "Cold-state reconstruction latency"),
    "store_state_cache_hits_total": ("counter", "State-cache hits"),
    "store_state_cache_misses_total": ("counter", "State-cache misses"),
    "store_batch_commit_total":
        ("counter", "Atomic StoreOp batches committed (one CRC'd log "
                    "record each)"),
    "store_recovery_repairs_total":
        ("counter", "Repairs applied by resume_chain's recovery ladder"),
    "store_fsck_errors_total":
        ("counter", "Consistency errors reported by store fsck"),
    # -- crypto hot spots -------------------------------------------------
    "bls_batch_verify_sigs": ("hist", "Signatures per device batch"),
    "bls_device_pairing_seconds": ("hist", "Device pairing-check latency"),
    "tree_hash_root_seconds": ("hist", "BeaconState tree_hash latency"),
    # -- CoW state columns (containers/cow.py) ----------------------------
    "state_copy_seconds":
        ("hist", "BeaconState.copy latency (CoW fork of every column)"),
    "state_cow_chunks_materialized":
        ("counter", "CoW chunks privatized by writes (copied out of a "
                    "shared column)"),
    "state_cow_chunks_shared":
        ("counter", "CoW chunks shared by reference at fork time"),
    "kzg_blob_verification_seconds": ("hist", "Blob batch verify latency"),
    # -- execution layer --------------------------------------------------
    "execution_layer_new_payload_seconds":
        ("hist", "engine_newPayload round-trip"),
    "execution_layer_forkchoice_seconds":
        ("hist", "engine_forkchoiceUpdated round-trip"),
    "execution_layer_payload_source_builder_total":
        ("counter", "Payloads taken from the builder"),
    "execution_layer_payload_source_local_total":
        ("counter", "Locally-built payloads"),
    # -- validator monitor / block times ---------------------------------
    "validator_monitor_attestation_hits_total":
        ("counter", "Monitored validators' timely attestations"),
    "validator_monitor_missed_blocks_total":
        ("counter", "Monitored validators' missed proposals"),
    "beacon_block_observed_delay_seconds":
        ("hist", "Slot start -> block first observed"),
    "beacon_block_imported_delay_seconds":
        ("hist", "Observed -> imported"),
    "beacon_block_head_delay_seconds":
        ("hist", "Imported -> became head"),
    # -- system health ----------------------------------------------------
    "process_cpu_percent": ("gauge", "Process CPU utilisation"),
    "process_resident_memory_bytes": ("gauge", "RSS"),
    "system_load_1m": ("gauge", "1-minute load average"),
    "system_disk_free_bytes": ("gauge", "Free disk on the data volume"),
    "process_open_fds": ("gauge", "Open file descriptors"),
    # -- graftscope tracing (obs/) ----------------------------------------
    "beacon_block_pipeline_seconds":
        ("hist", "Gossip arrival -> imported, whole pipeline trace"),
    "beacon_processor_work_seconds":
        ("hist", "Beacon-processor work item execution latency"),
    "bench_stage_seconds":
        ("hist", "bench.py --trace per-stage latency"),
    "stf_epoch_seconds":
        ("hist", "per_epoch_processing wall time (epoch boundary in the "
                 "node, 1M-validator envelope in bench.py stf mode)"),
    "stf_block_seconds":
        ("hist", "per_block_processing wall time for one imported block"),
    # -- API serving tier (api/serving/) ----------------------------------
    "api_requests_total":
        ("counter", "Requests entering the serving tier"),
    "api_cache_hits_total":
        ("counter", "Serving-tier response-cache hits (pre-encoded "
                    "bytes served without a backend call)"),
    "api_cache_misses_total":
        ("counter", "Serving-tier response-cache misses"),
    "api_shed_total":
        ("counter", "Requests shed by the serving tier's priority "
                    "admission queue (HTTP 503)"),
    "api_request_seconds":
        ("hist", "Serving-tier request latency (api_request span: "
                 "admission + cache/coalesce + backend)"),
    # -- graftflow replay pipeline (chain/replay/) ------------------------
    "replay_stage_admission_seconds":
        ("hist", "Replay admission stage latency (known-block filter, "
                 "parent check, epoch chunking)"),
    "replay_stage_signature_seconds":
        ("hist", "Replay epoch-amortized signature verification latency "
                 "(one verify_signature_sets per epoch)"),
    "replay_stage_stf_seconds":
        ("hist", "Replay per-block state transition latency (deferred "
                 "merkleization: claimed roots patched, no per-slot "
                 "hash)"),
    "replay_stage_merkle_seconds":
        ("hist", "Replay per-epoch incremental-hasher flush latency"),
    "replay_stage_commit_seconds":
        ("hist", "Replay per-epoch atomic commit latency (one StoreOp "
                 "batch + fork choice + head recompute)"),
    "replay_sigs_deduped_total":
        ("counter", "Proposal signature sets skipped during replay "
                    "because the exact block root already passed the "
                    "gossip-edge proposer check"),
    "replay_blocks_committed_total":
        ("counter", "Blocks committed by the replay pipeline"),
    "replay_epochs_committed_total":
        ("counter", "Epoch batches committed by the replay pipeline"),
    "replay_active":
        ("gauge", "1 while a replay segment is in flight"),
    "replay_queue_depth_signature":
        ("gauge", "Replay signature hand-off queue depth"),
    "replay_queue_depth_commit":
        ("gauge", "Replay commit hand-off queue depth"),
    # -- kernel build + transfer accounting (obs/cuda_accounting) --------
    "kernel_build_total":
        ("counter", "CUDA kernel libraries nvcc built at runtime (a build "
                    "the _build/ cache did not hold)"),
    "kernel_build_seconds_total":
        ("counter", "Seconds nvcc spent building kernel libraries"),
    "device_transfer_host_to_device_bytes_total":
        ("counter", "Accounted host->device bytes (mesh.shard_batch)"),
    "device_transfer_device_to_host_bytes_total":
        ("counter", "Accounted device->host bytes (obs.host_readback)"),
    "kernel_libraries_loaded":
        ("gauge", "Kernel libraries bound (ctypes) in this process"),
    # -- device ledger + roofline (obs/device, obs/roofline) -------------
    "device_hbm_bytes_in_use":
        ("gauge", "Device memory bytes in use summed across cards (absent "
                  "where CUDA is not initialised, e.g. on the CPU)"),
    "device_hbm_bytes_limit":
        ("gauge", "HBM byte limit summed across devices"),
    "roofline_utilization_ratio":
        ("gauge", "Bound over measured device time for the last "
                  "roofline-timed call of each kernel variant (label "
                  "kernel)"),
    "kernel_build_cache_hits_total":
        ("counter", "Kernel libraries found built in _build/"),
    "kernel_build_cache_misses_total":
        ("counter", "Kernel libraries nvcc had to build"),
}

#: JAX package metric name -> the port's, for the entries whose meaning
#: moved with the runtime (every other name is the JAX package's own)
PORT_NAMES: dict[str, str] = {
    "jax_compile_total": "kernel_build_total",
    "jax_compile_seconds_total": "kernel_build_seconds_total",
    "jax_transfer_host_to_device_bytes_total":
        "device_transfer_host_to_device_bytes_total",
    "jax_transfer_device_to_host_bytes_total":
        "device_transfer_device_to_host_bytes_total",
    "jax_jit_cache_entries": "kernel_libraries_loaded",
    "jax_compile_cache_hits_total": "kernel_build_cache_hits_total",
    "jax_compile_cache_misses_total": "kernel_build_cache_misses_total",
}

#: Histograms declared for dashboard parity but fed outside the node
#: process (tier-1's catalog-completeness test accepts these).  Keyed by
#: name with the feeding agent as the justification.
EXTERNALLY_FED: dict[str, str] = {
    "bls_device_pairing_seconds":
        "observed by the bench harness (bench.py bls mode), which is "
        "the only place the device pairing check runs end-to-end with a "
        "meaningful batch on real hardware",
}


#: catalog gauges kept as one series a label value, and their label
#: names: the roofline ratio of each kernel variant a process timed
LABELS = {"roofline_utilization_ratio": ("kernel",)}


def register_catalog() -> int:
    """Force-register every catalog entry (so /metrics exposes the full
    inventory even before first use); returns the count."""
    for name, (kind, help_) in CATALOG.items():
        if kind == "counter":
            metrics.inc_counter(name, help_, 0)
        elif name in LABELS:
            metrics._get(metrics.Gauge, name, help_, labelnames=LABELS[name])
        elif kind == "gauge":
            metrics.set_gauge(name, 0, help_)
        else:
            metrics._get(metrics.Histogram, name, help_)
    return len(CATALOG)


def timed(name: str):
    """Catalog-checked timer."""
    assert name in CATALOG, f"unknown metric {name}"
    return metrics.timer(name, CATALOG[name][1])


def count(name: str, amount: float = 1) -> None:
    metrics.inc_counter(name, CATALOG.get(name, ("", name))[1], amount)


def gauge(name: str, value: float, **labels) -> None:
    metrics.set_gauge(name, value, CATALOG.get(name, ("", name))[1],
                      labels or None)


def observe(name: str, value: float) -> None:
    metrics.observe(name, value, CATALOG.get(name, ("", name))[1])
