from .constants import *  # noqa: F401,F403
from .presets import Preset, MAINNET_PRESET, MINIMAL_PRESET
from .chain_spec import (
    ChainSpec, ForkName, FORK_ORDER, mainnet_spec, minimal_spec,
    compute_fork_data_root, compute_fork_digest, compute_domain,
    compute_signing_root,
)
