"""Named networks and the EIP-2386 wallet.

The cases of the JAX package's tests/test_tooling.py whose modules the
port holds (``specs.networks``, ``crypto.wallet``), run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after each test).  The rest of that file needs the
validator client, the validator manager and the watch monitor.
"""
import pytest

from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True)
def fake_crypto():
    prev, saved = set_device("cpu"), bls._current
    bls.set_backend("fake")
    yield
    bls._current = saved
    set_device(prev)


def test_eip2386_wallet_roundtrip(tmp_path):
    """EIP-2386 hd wallet: create, derive sequential validators at the
    EIP-2334 paths, keystore export, nextaccount persistence."""
    from lighthouse_tpu_torch.crypto import bls
    bls.set_backend("python")
    from lighthouse_tpu_torch.crypto.key_derivation import derive_path
    from lighthouse_tpu_torch.crypto.keystore import decrypt_keystore
    from lighthouse_tpu_torch.crypto.wallet import Wallet, WalletManager
    wm = WalletManager(str(tmp_path))
    w = wm.create("primary", b"wpass")
    assert wm.list() == ["primary"]
    assert w.nextaccount == 0
    i0, v0, wd0 = w.derive_validator(b"wpass")
    i1, v1, _ = w.derive_validator(b"wpass")
    assert (i0, i1) == (0, 1) and v0 != v1 and v0 != wd0
    # derivation matches EIP-2334 paths from the decrypted seed
    from lighthouse_tpu_torch.crypto.wallet import decrypt_seed
    seed = decrypt_seed(w.data, b"wpass")
    assert v0 == derive_path(seed, "m/12381/3600/0/0/0")
    assert wd0 == derive_path(seed, "m/12381/3600/0/0")
    # keystore export decrypts back to the derived voting key
    ks = w.next_validator_keystore(b"wpass", b"kpass")
    assert decrypt_keystore(ks, b"kpass") == derive_path(
        seed, "m/12381/3600/2/0/0")
    wm.save(w)
    # persistence of nextaccount across reopen
    w2 = wm.open("primary")
    assert w2.nextaccount == 3
    # wrong password rejected
    import pytest as _pytest
    with _pytest.raises(ValueError):
        w2.derive_validator(b"wrong")


def test_network_configs_and_testnet_dir(tmp_path):
    """Baked-in named networks + testnet-dir config.yaml loading
    (common/eth2_network_config/src/lib.rs:32-53)."""
    from lighthouse_tpu_torch.specs.networks import (
        load_testnet_dir, network_spec,
    )
    sep = network_spec("sepolia")
    assert sep.genesis_fork_version == bytes.fromhex("90000069")
    assert sep.capella_fork_epoch == 56832
    hol = network_spec("holesky")
    assert hol.altair_fork_epoch == 0
    assert network_spec("mainnet").config_name == "mainnet"
    with pytest.raises(ValueError):
        network_spec("nonsense")
    (tmp_path / "config.yaml").write_text(
        "PRESET_BASE: 'minimal'\n"
        "CONFIG_NAME: 'devnet-7'\n"
        "SECONDS_PER_SLOT: 3\n"
        "GENESIS_FORK_VERSION: 0x10000001\n"
        "ALTAIR_FORK_VERSION: 0x10000002\n"
        "ALTAIR_FORK_EPOCH: 1\n")
    spec = load_testnet_dir(str(tmp_path))
    assert spec.config_name == "devnet-7"
    assert spec.seconds_per_slot == 3
    assert spec.preset.name == "minimal"
    assert spec.altair_fork_epoch == 1
    # a chain actually boots on the custom network
    from lighthouse_tpu_torch.crypto import bls
    bls.set_backend("fake")
    from lighthouse_tpu_torch.chain import BeaconChainHarness
    h = BeaconChainHarness(spec, 16)
    h.extend_chain(2)
    assert h.chain.head().head_state.slot == 2


def test_gnosis_network_spec():
    """Gnosis preset + config: eth_spec.rs:520
    shapes and chain_spec.rs:933 parameters."""
    from lighthouse_tpu_torch.specs.networks import network_spec
    s = network_spec("gnosis")
    assert s.preset.name == "gnosis"
    assert s.preset.slots_per_epoch == 16
    assert s.preset.epochs_per_sync_committee_period == 512
    assert s.preset.max_withdrawals_per_payload == 8
    assert s.preset.base_reward_factor == 25
    assert s.seconds_per_slot == 5
    assert s.churn_limit_quotient == 4096
    assert s.genesis_fork_version == bytes.fromhex("00000064")
    assert s.deposit_chain_id == 100
    # fork schedule ordering
    assert s.altair_fork_epoch == 512
    assert s.deneb_fork_epoch == 889856
    # SSZ types build on the gnosis preset
    from lighthouse_tpu_torch.containers import get_types
    T = get_types(s.preset)
    assert T.preset.slots_per_epoch == 16


def test_config_dump_roundtrip(tmp_path):
    """Every named network's config dumps to the standard config.yaml
    keys and loads back to an equivalent spec (the reference's
    check_dump_configs flag-test discipline, main.rs:707-713)."""
    from lighthouse_tpu_torch.specs.networks import (
        NETWORKS, dump_config_yaml, load_testnet_dir, network_spec,
        spec_to_config,
    )
    for name in NETWORKS:
        spec = network_spec(name)
        d = tmp_path / name
        d.mkdir()
        dump_config_yaml(spec, str(d / "config.yaml"))
        back = load_testnet_dir(str(d))
        assert back.preset.name == spec.preset.name, name
        for field in ("config_name", "min_genesis_time",
                      "seconds_per_slot", "genesis_fork_version",
                      "altair_fork_epoch", "bellatrix_fork_epoch",
                      "capella_fork_epoch", "deneb_fork_epoch",
                      "electra_fork_epoch", "shard_committee_period"):
            assert getattr(back, field) == getattr(spec, field), \
                (name, field)
        # and the dump is stable (dump(load(dump)) == dump)
        assert spec_to_config(back) == spec_to_config(spec), name
