"""BeaconChainBuilder (beacon_chain/src/builder.rs equivalent): staged wiring
of store/clock/execution-layer/genesis, incl. checkpoint-sync anchors
(client/src/builder.rs:341-497)."""
from __future__ import annotations

from ..containers.state import BeaconState
from ..specs.chain_spec import ChainSpec
from ..state_transition import interop_genesis_state
from ..state_transition.helpers import latest_block_header_root
from ..store import HotColdDB, MemoryStore
from ..utils.slot_clock import ManualSlotClock, SlotClock, SystemTimeSlotClock
from .beacon_chain import BeaconChain, ChainConfig
from .execution import ExecutionLayerInterface, MockExecutionLayer


class BeaconChainBuilder:
    def __init__(self, spec: ChainSpec):
        self.spec = spec
        self._store: HotColdDB | None = None
        self._clock: SlotClock | None = None
        self._el: ExecutionLayerInterface | None = None
        self._genesis_state: BeaconState | None = None
        self._genesis_block = None
        self._config = ChainConfig()

    def store(self, store: HotColdDB) -> "BeaconChainBuilder":
        self._store = store
        return self

    def slot_clock(self, clock: SlotClock) -> "BeaconChainBuilder":
        self._clock = clock
        return self

    def execution_layer(self, el: ExecutionLayerInterface
                        ) -> "BeaconChainBuilder":
        self._el = el
        return self

    def chain_config(self, config: ChainConfig) -> "BeaconChainBuilder":
        self._config = config
        return self

    def genesis_state(self, state: BeaconState) -> "BeaconChainBuilder":
        self._genesis_state = state
        return self

    def interop_genesis(self, secret_keys: list[int],
                        genesis_time: int = 0) -> "BeaconChainBuilder":
        self._genesis_state = interop_genesis_state(
            self.spec, secret_keys, genesis_time=genesis_time)
        return self

    def weak_subjectivity_anchor(self, state: BeaconState,
                                 signed_block) -> "BeaconChainBuilder":
        """Checkpoint sync: anchor on a finalized state+block
        (ClientGenesis::CheckpointSyncUrl / WeakSubjSszBytes)."""
        self._genesis_state = state
        self._genesis_block = signed_block
        return self

    def resume_from_store(self, store: HotColdDB,
                          anchor=None) -> "BeaconChainBuilder":
        """ClientGenesis::FromStore (client/src/config.rs:33): boot from a
        previously-anchored database. Pass `anchor` when already loaded (it
        is a full cold-state fetch)."""
        anchor = anchor if anchor is not None else store.anchor_state()
        if anchor is None:
            raise ValueError("store has no anchor to resume from")
        self._store = store
        self._genesis_state = anchor
        # restore the anchor block so head_block is never None even when
        # fork choice was never persisted (pre-first-finalization restarts)
        root = store.genesis_block_root()
        if root is not None:
            self._genesis_block = store.get_block(root)
        self._resume = True
        return self

    def build(self) -> BeaconChain:
        assert self._genesis_state is not None, "genesis required"
        store = self._store or HotColdDB(MemoryStore(), MemoryStore(),
                                         self.spec)
        clock = self._clock or SystemTimeSlotClock(
            self._genesis_state.genesis_time, self.spec.seconds_per_slot)
        el = self._el or MockExecutionLayer()
        chain = BeaconChain(self.spec, store, clock, el,
                            self._genesis_state, self._genesis_block,
                            self._config)
        if getattr(self, "_resume", False):
            chain.resume()
        return chain
