"""Client assembly (L9): the staged builder wiring every service.

Equivalent of the reference's beacon_node/client (ClientBuilder staged build,
src/builder.rs:158..1108) + lighthouse/environment (runtime context,
graceful shutdown).
"""
from .builder import ClientBuilder, Client
from .environment import Environment, RuntimeContext
