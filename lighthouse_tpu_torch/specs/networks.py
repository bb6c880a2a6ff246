"""Baked-in network configs + testnet-dir loading.

Equivalent of common/eth2_network_config/src/lib.rs:32-53: named networks
resolve to a full ChainSpec (fork schedule, deposit contract, genesis
metadata), and ``--testnet-dir`` loads a custom ``config.yaml`` in the
standard consensus-configs key format (a genesis state ssz may sit next
to it as ``genesis.ssz``).
"""
from __future__ import annotations

import os

from .chain_spec import ChainSpec, mainnet_spec, minimal_spec
from .presets import GNOSIS_PRESET, MAINNET_PRESET, MINIMAL_PRESET


def _v(hexstr: str) -> bytes:
    return bytes.fromhex(hexstr)


def sepolia_spec() -> ChainSpec:
    return ChainSpec(
        preset=MAINNET_PRESET,
        config_name="sepolia",
        min_genesis_time=1655647200,
        min_genesis_active_validator_count=1300,
        genesis_fork_version=_v("90000069"),
        altair_fork_version=_v("90000070"), altair_fork_epoch=50,
        bellatrix_fork_version=_v("90000071"), bellatrix_fork_epoch=100,
        capella_fork_version=_v("90000072"), capella_fork_epoch=56832,
        deneb_fork_version=_v("90000073"), deneb_fork_epoch=132608,
    )


def holesky_spec() -> ChainSpec:
    return ChainSpec(
        preset=MAINNET_PRESET,
        config_name="holesky",
        min_genesis_time=1695902100,
        min_genesis_active_validator_count=16384,
        genesis_fork_version=_v("01017000"),
        altair_fork_version=_v("02017000"), altair_fork_epoch=0,
        bellatrix_fork_version=_v("03017000"), bellatrix_fork_epoch=0,
        capella_fork_version=_v("04017000"), capella_fork_epoch=256,
        deneb_fork_version=_v("05017000"), deneb_fork_epoch=29696,
    )


def gnosis_spec() -> ChainSpec:
    """Gnosis chain (consensus/types/src/chain_spec.rs:933 gnosis())."""
    return ChainSpec(
        preset=GNOSIS_PRESET,
        config_name="gnosis",
        seconds_per_slot=5,
        genesis_delay=6000,
        min_genesis_time=1638968400,
        min_genesis_active_validator_count=4096,
        churn_limit_quotient=4096,
        max_per_epoch_activation_churn_limit=2,
        deposit_chain_id=100,
        deposit_network_id=100,
        deposit_contract_address=bytes.fromhex(
            "0b98057ea310f4d31f2a452b414647007d1645d9"),
        eth1_follow_distance=1024,
        seconds_per_eth1_block=6,
        terminal_total_difficulty=(
            8626000000000000000000058750000000000000000000),
        genesis_fork_version=_v("00000064"),
        altair_fork_version=_v("01000064"), altair_fork_epoch=512,
        bellatrix_fork_version=_v("02000064"),
        bellatrix_fork_epoch=385536,
        capella_fork_version=_v("03000064"), capella_fork_epoch=648704,
        deneb_fork_version=_v("04000064"), deneb_fork_epoch=889856,
        electra_fork_version=_v("05000064"),
    )


NETWORKS = {
    "mainnet": mainnet_spec,
    "minimal": minimal_spec,
    "sepolia": sepolia_spec,
    "holesky": holesky_spec,
    "gnosis": gnosis_spec,
}


def network_spec(name: str) -> ChainSpec:
    try:
        return NETWORKS[name]()
    except KeyError:
        raise ValueError(f"unknown network {name!r}; "
                         f"choices: {sorted(NETWORKS)}") from None


def _version(v) -> bytes:
    """yaml may parse 0x-prefixed versions as ints or strings."""
    if isinstance(v, int):
        return v.to_bytes(4, "big")
    s = str(v)
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


_YAML_KEYS = {
    # config.yaml key -> (ChainSpec field, parser)
    "CONFIG_NAME": ("config_name", str),
    "MIN_GENESIS_TIME": ("min_genesis_time", int),
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT":
        ("min_genesis_active_validator_count", int),
    "GENESIS_DELAY": ("genesis_delay", int),
    "SECONDS_PER_SLOT": ("seconds_per_slot", int),
    "ETH1_FOLLOW_DISTANCE": ("eth1_follow_distance", int),
    "SHARD_COMMITTEE_PERIOD": ("shard_committee_period", int),
    "GENESIS_FORK_VERSION": ("genesis_fork_version",
                             _version),
    "ALTAIR_FORK_VERSION": ("altair_fork_version",
                            _version),
    "ALTAIR_FORK_EPOCH": ("altair_fork_epoch", int),
    "BELLATRIX_FORK_VERSION": ("bellatrix_fork_version",
                               _version),
    "BELLATRIX_FORK_EPOCH": ("bellatrix_fork_epoch", int),
    "CAPELLA_FORK_VERSION": ("capella_fork_version",
                             _version),
    "CAPELLA_FORK_EPOCH": ("capella_fork_epoch", int),
    "DENEB_FORK_VERSION": ("deneb_fork_version",
                           _version),
    "DENEB_FORK_EPOCH": ("deneb_fork_epoch", int),
    "ELECTRA_FORK_VERSION": ("electra_fork_version",
                             _version),
    "ELECTRA_FORK_EPOCH": ("electra_fork_epoch", int),
}


_PRESETS_BY_BASE = {"mainnet": MAINNET_PRESET, "minimal": MINIMAL_PRESET,
                    "gnosis": GNOSIS_PRESET}


def load_testnet_dir(path: str) -> ChainSpec:
    """Custom network from a testnet directory holding ``config.yaml``
    (consensus-configs format); PRESET_BASE selects the preset."""
    import yaml
    cfg_path = os.path.join(path, "config.yaml")
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    base = str(raw.get("PRESET_BASE", "mainnet")).strip("'\"")
    preset = _PRESETS_BY_BASE.get(base, MAINNET_PRESET)
    kw = {"preset": preset}
    for key, (field, parse) in _YAML_KEYS.items():
        if key in raw:
            kw[field] = parse(raw[key])
    return ChainSpec(**kw)


def spec_to_config(spec: ChainSpec) -> dict:
    """ChainSpec -> the standard config.yaml key dict — the inverse of
    load_testnet_dir over _YAML_KEYS (clap_utils::check_dump_configs
    round-trip role).  Values use the canonical upstream text forms."""
    out = {"PRESET_BASE": spec.preset.name}
    for key, (field, parse) in _YAML_KEYS.items():
        v = getattr(spec, field, None)
        if v is None:
            continue
        if isinstance(v, bytes):
            v = "0x" + v.hex()
        out[key] = v
    return out


def dump_config_yaml(spec: ChainSpec, path: str) -> None:
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(spec_to_config(spec), f, sort_keys=False)


def testnet_genesis_state(path: str, spec: ChainSpec):
    """Load genesis.ssz from a testnet dir, if present."""
    gpath = os.path.join(path, "genesis.ssz")
    if not os.path.exists(gpath):
        return None
    from ..containers import get_types
    from ..containers.state import BeaconState
    with open(gpath, "rb") as f:
        data = f.read()
    from .chain_spec import ForkName
    fork = spec.fork_name_at_epoch(0)
    return BeaconState.from_ssz_bytes(data, get_types(spec.preset), spec,
                                      fork)
