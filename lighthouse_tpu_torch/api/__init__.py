"""Beacon node API layer (L8).

Equivalent of the reference's beacon_node/http_api (19.5k LoC warp router):
- ``backend``: the API semantics over a BeaconChain (duties, blocks, states,
  validator endpoints) — shared by the HTTP server and the in-process
  adapter the VC/simulator use.
- ``http_server``: stdlib threading HTTP server exposing the eth2 routes.
- ``metrics``: Prometheus endpoint (http_metrics equivalent).
"""
from .backend import ApiBackend
from .http_server import BeaconApiServer
