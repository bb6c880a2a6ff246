"""Named networks, the EIP-2386 wallet, the validator manager, the watch
monitor and the command line.

The cases of the JAX package's tests/test_tooling.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after each test).
"""
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.validator_client import (
    SlashingError, ValidatorStore,
)
from lighthouse_tpu_torch.validator_manager import (
    create_validators, import_validators, move_validators,
)
from lighthouse_tpu_torch.watch import WatchMonitor


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


def test_bulk_create_and_import(tmp_path):
    seed = bytes(range(32))
    keystores = create_validators(seed, 3, str(tmp_path), b"pw")
    assert len(keystores) == 3
    spec = minimal_spec()
    store = ValidatorStore(spec, b"\x11" * 32)
    assert import_validators(str(tmp_path), b"pw", store) == 3
    assert len(store.voting_pubkeys()) == 3


def test_move_carries_slashing_history():
    spec = minimal_spec()
    gvr = b"\x22" * 32
    src = ValidatorStore(spec, gvr)
    dst = ValidatorStore(spec, gvr)
    pk = src.add_validator(12345)
    # sign an attestation data in src, then move
    from lighthouse_tpu_torch.containers import get_types
    T = get_types(spec.preset)
    data = T.AttestationData(slot=8, index=0,
                             beacon_block_root=b"\x01" * 32,
                             source=T.Checkpoint(epoch=1, root=b"\x02" * 32),
                             target=T.Checkpoint(epoch=2, root=b"\x03" * 32))
    src.sign_attestation(pk, data)
    assert move_validators(src, dst, [pk], gvr) == 1
    assert pk not in src._keys and pk in dst._keys
    # surrounding vote must still be refused at the destination
    bad = T.AttestationData(slot=8, index=0,
                            beacon_block_root=b"\x01" * 32,
                            source=T.Checkpoint(epoch=0, root=b"\x02" * 32),
                            target=T.Checkpoint(epoch=3, root=b"\x04" * 32))
    with pytest.raises(SlashingError):
        dst.sign_attestation(pk, bad)


def test_watch_monitor():
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 64)
    mon = WatchMonitor(h.chain)
    h.extend_chain(2 * spec.preset.slots_per_epoch)
    added = mon.update()
    # +1: the synthesized slot-0 genesis block is stored and canonical
    assert added == 2 * spec.preset.slots_per_epoch + 1
    rewards = mon.block_rewards_range(1, 16)
    assert len(rewards) == 16
    # full sync participation from the harness aggregates
    assert all(r[3] == 1.0 for r in rewards)
    top = mon.top_proposers(3)
    assert top and top[0][1] >= 1
    assert mon.missed_slots(1, 16) == []
    part = mon.participation(h.chain.head().head_state.previous_epoch())
    assert part is not None and part[0] > 0.9
    # blockprint: harness blocks carry empty graffiti -> Unknown; the
    # classifier itself fingerprints client strings
    from lighthouse_tpu_torch.watch.monitor import classify_graffiti
    assert classify_graffiti(b"Lighthouse/v4.5.0") == "Lighthouse"
    assert classify_graffiti(b"lighthouse_tpu/r2") == "LighthouseTpu"
    assert classify_graffiti(b"teku/23.10") == "Teku"
    assert classify_graffiti(b"\x00" * 32) == "Unknown"
    div = mon.blockprint_diversity()
    assert div and div[0]["client"] == "Unknown"
    assert abs(sum(d["share"] for d in div) - 1.0) < 1e-9
    assert mon.blockprint_block(1) == "Unknown"


def test_watch_http_server_and_metrics_timers():
    """Watch HTTP server routes + hot-path metric timers."""
    import json
    import urllib.request
    from lighthouse_tpu_torch.api import metrics
    from lighthouse_tpu_torch.crypto import bls
    bls.set_backend("fake")
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 32)
    h.extend_chain(spec.preset.slots_per_epoch)
    mon = WatchMonitor(h.chain)
    srv = __import__("lighthouse_tpu_torch.watch.monitor",
                     fromlist=["WatchServer"]).WatchServer(mon)
    srv.start()
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}") as r:
                return json.loads(r.read())
        rows = get("/v1/blocks?start=1&end=8")["data"]
        assert rows and rows[0]["slot"] >= 1
        one = get(f"/v1/blocks/{rows[0]['slot']}")["data"]
        assert one["slot"] == rows[0]["slot"]
        top = get("/v1/validators/proposers")["data"]
        assert top and top[0]["blocks"] >= 1
        missed = get("/v1/slots/missed?start=1&end=8")["data"]
        assert missed == []
        bp = get(f"/v1/blockprint/blocks/{rows[0]['slot']}")["data"]
        assert bp["best_guess_single"]
        div = get("/v1/blockprint/diversity")["data"]
        assert div and div[0]["blocks"] >= 1
    finally:
        srv.stop()
    # hot-path timers recorded through the live metrics module
    from lighthouse_tpu_torch.crypto.bls import SignatureSet
    b = bls.get_backend()
    bls.verify_signature_sets([SignatureSet(b"\x00" * 96, [b"\x00" * 48],
                                            b"m")])
    from prometheus_client import generate_latest
    text = generate_latest(metrics.REGISTRY).decode()
    assert "beacon_batch_verify_seconds" in text
    assert "beacon_batch_verify_signature_sets" in text
    assert "validator_registry_tree_hash_seconds" in text
    with metrics.timer("unit_test_timer_seconds"):
        pass
    text = generate_latest(metrics.REGISTRY).decode()
    assert "unit_test_timer_seconds" in text


def test_testnet_dir_genesis_state_is_loaded(tmp_path):
    """--testnet-dir genesis.ssz must become THE genesis state (ignoring
    it forks the node off its own network)."""
    from lighthouse_tpu_torch.crypto import bls
    bls.set_backend("fake")
    from lighthouse_tpu_torch.specs.networks import (
        load_testnet_dir, testnet_genesis_state,
    )
    from lighthouse_tpu_torch.state_transition import interop_genesis_state
    (tmp_path / "config.yaml").write_text(
        "PRESET_BASE: 'minimal'\nCONFIG_NAME: 'devnet-g'\n")
    spec = load_testnet_dir(str(tmp_path))
    real = interop_genesis_state(
        spec, [bls.keygen_interop(i) for i in range(16)], genesis_time=7)
    (tmp_path / "genesis.ssz").write_bytes(real.serialize())
    loaded = testnet_genesis_state(str(tmp_path), spec)
    assert loaded is not None
    assert loaded.hash_tree_root() == real.hash_tree_root()
    # and it threads through the client config into the chain
    from lighthouse_tpu_torch.client.builder import ClientBuilder, ClientConfig
    cfg = ClientConfig(genesis_state=loaded, http_enabled=False)
    client = ClientBuilder(spec).with_config(cfg).build()
    try:
        assert client.chain.genesis_state.hash_tree_root() == \
            real.hash_tree_root()
    finally:
        client.stop() if hasattr(client, "stop") else None
        # the node's slot timer runs in the client's environment: end it
        client.env.shutdown("test over")


def test_cli_dump_config_flag(tmp_path, capsys):
    """lighthouse bn --network gnosis --dump-config prints the resolved
    config and exits cleanly (no node start)."""
    import json as _json
    from lighthouse_tpu_torch.__main__ import main
    rc = main(["--network", "gnosis", "beacon_node", "--dump-config"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    cfg = _json.loads(out)
    assert cfg["spec"]["CONFIG_NAME"] == "gnosis"
    assert cfg["spec"]["PRESET_BASE"] == "gnosis"
    assert cfg["spec"]["SECONDS_PER_SLOT"] == 5


def test_watch_packing_and_suboptimal_analysis():
    """watch depth: block-packing efficiency rows
    and suboptimal-attestation rows land in the DB and serve over HTTP
    (watch/src/{block_packing,suboptimal_attestations})."""
    import json as _json
    import urllib.request

    from lighthouse_tpu_torch.chain import BeaconChainHarness
    from lighthouse_tpu_torch.crypto import bls as _bls
    from lighthouse_tpu_torch.specs import minimal_spec as _ms
    from lighthouse_tpu_torch.watch import WatchMonitor
    _bls.set_backend("fake")
    spec = _ms(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, 32)
    # attest with only 3/4 of validators so some are suboptimal
    for _ in range(2 * spec.preset.slots_per_epoch):
        h.advance_slot()
        signed, _post = h.produce_signed_block()
        h.chain.process_block(signed)
        h.attest_to_head(list(range(24)))
    mon = WatchMonitor(h.chain)
    added = mon.update()
    assert added > 0
    head_slot = int(h.chain.head().head_state.slot)
    packing = mon.block_packing(1, head_slot)
    assert packing, "no packing rows"
    for row in packing:
        assert 0 <= row["efficiency"] <= 1
        assert row["available"] >= row["included"]
    epoch = h.chain.head().head_state.previous_epoch()
    sub = mon.suboptimal_at_epoch(epoch)
    assert sub, "no suboptimal attesters recorded"
    assert all(not (s["source"] and s["target"] and s["head"])
               for s in sub)
    # per-validator history
    hist = mon.validator_attestation_history(sub[0]["validator_index"])
    assert hist and "epoch" in hist[0]
    # over HTTP
    from lighthouse_tpu_torch.watch.monitor import WatchServer
    srv = WatchServer(mon)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(
                f"{base}/v1/blocks/packing?start=1&end={head_slot}") as r:
            assert _json.loads(r.read())["data"]
        with urllib.request.urlopen(
                f"{base}/v1/epochs/{epoch}/suboptimal") as r:
            assert _json.loads(r.read())["data"]
        v = sub[0]["validator_index"]
        with urllib.request.urlopen(
                f"{base}/v1/validators/{v}/attestations") as r:
            assert _json.loads(r.read())["data"]
    finally:
        srv.stop()


def test_validator_manager_cli_create_import_move(tmp_path):
    """validator_manager subcommands end-to-end (the reference's
    validator_manager crate surface: bulk create -> import -> move with
    slashing history)."""
    import json as _j

    from lighthouse_tpu_torch.__main__ import main as cli

    ks_dir = tmp_path / "keystores"
    rc = cli(["vm", "create", "--seed-hex", "cd" * 32, "--count", "2",
              "--out-dir", str(ks_dir), "--password", "pw"])
    assert rc == 0
    files = sorted(ks_dir.glob("*.json"))
    assert len(files) == 2
    rc = cli(["vm", "import", "--keystore-dir", str(ks_dir),
              "--password", "pw", "--datadir", str(tmp_path / "src")])
    assert rc == 0
    assert (tmp_path / "src" / "slashing_protection.sqlite").exists()
    pk = "0x" + _j.load(open(files[0]))["pubkey"]
    rc = cli(["vm", "move", "--src-datadir", str(tmp_path / "src"),
              "--dst-datadir", str(tmp_path / "dst"),
              "--keystore-dir", str(ks_dir), "--password", "pw",
              "--pubkeys", pk])
    assert rc == 0
    assert (tmp_path / "dst" / "slashing_protection.sqlite").exists()
