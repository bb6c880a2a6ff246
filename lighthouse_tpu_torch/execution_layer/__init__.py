"""Execution layer bridge (L6).

Equivalent of the reference's beacon_node/execution_layer (11.3k LoC):
engine JSON-RPC over HTTP with JWT auth (engine_api/{http,auth}.rs),
capability negotiation, the Engines health state machine (engines.rs), and
the in-process mock engine server used by tests
(test_utils/{mock_server,handle_rpc}.rs equivalent).
"""
from .engine_api import EngineApiClient, JwtAuth, EngineError
from .engines import Engines, EngineState
from .execution_layer import ExecutionLayer
from .mock_engine import MockEngineServer
