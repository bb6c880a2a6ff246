"""Rule modules register themselves with the engine on import."""
from . import (  # noqa: F401
    compile_budget,
    cow_discipline,
    data_race,
    device_transfer,
    lock_discipline,
    lock_order,
    recompilation,
    serving_cache_discipline,
    shutdown_order,
    spec_constants,
    ssz_schema,
    store_atomicity,
    thread_lifecycle,
    trace_safety,
)
