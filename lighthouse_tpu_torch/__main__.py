"""CLI (L10): `python -m lighthouse_tpu_torch <subcommand>`.

Equivalent of the reference's lighthouse/src/main.rs subcommand dispatch
(:412-416): beacon_node, validator_client, account_manager, database_manager,
plus lcli-style dev tools. Flags fold into typed configs
(beacon_node/src/{cli,config}.rs).
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        prog="lighthouse_tpu_torch",
        description="CUDA-native Ethereum consensus client")
    from .specs.networks import NETWORKS
    parser.add_argument("--network", default="minimal",
                        choices=sorted(NETWORKS),
                        help="baked-in network config")
    parser.add_argument("--testnet-dir", default=None,
                        help="custom network dir with config.yaml "
                             "(overrides --network)")
    parser.add_argument("--log-level", default="INFO")
    sub = parser.add_subparsers(dest="cmd", required=True)

    bn = sub.add_parser("beacon_node", aliases=["bn", "beacon"])
    bn.add_argument("--datadir", default=None)
    bn.add_argument("--http-port", type=int, default=5052)
    bn.add_argument("--disable-http", action="store_true",
                    help="do not start the HTTP API server")
    bn.add_argument("--metrics", action="store_true")
    bn.add_argument("--metrics-port", type=int, default=5054)
    bn.add_argument("--listen-address", default="127.0.0.1",
                    help="libp2p + discovery listen address")
    bn.add_argument("--target-peers", type=int, default=16)
    bn.add_argument("--discovery-port", type=int, default=0,
                    help="discv5 UDP port (0 = ephemeral)")
    bn.add_argument("--upnp", action="store_true",
                    help="attempt UPnP port mapping at startup")
    bn.add_argument("--subscribe-all-subnets", action="store_true",
                    help="advertise + subscribe every attestation subnet")
    bn.add_argument("--graffiti", default="",
                    help="ascii graffiti for locally produced blocks")
    bn.add_argument("--suggested-fee-recipient", default=None,
                    help="0x-prefixed 20-byte default fee recipient")
    bn.add_argument("--snapshot-cache-size", type=int, default=8)
    bn.add_argument("--reorg-threshold", type=int, default=20,
                    help="late-block re-org weight threshold (percent)")
    bn.add_argument("--disable-light-client-server", action="store_true")
    bn.add_argument("--validator-monitor-pubkeys", default="",
                    help="comma-separated 0x pubkeys to monitor")
    bn.add_argument("--purge-db", action="store_true",
                    help="wipe the datadir's chain database on startup")
    bn.add_argument("--port", type=int, default=9000,
                    help="p2p listen port")
    bn.add_argument("--boot-nodes", default="",
                    help="comma-separated host:port list")
    bn.add_argument("--slasher", action="store_true")
    bn.add_argument("--crypto-backend", default="gpu",
                    choices=["python", "fake", "gpu", "cpp"])
    bn.add_argument("--interop-validators", type=int, default=0)
    bn.add_argument("--genesis-time", type=int, default=None)
    bn.add_argument("--checkpoint-state", default=None,
                    help="SSZ state file for checkpoint sync")
    bn.add_argument("--checkpoint-block", default=None)
    bn.add_argument("--dump-config", action="store_true")

    vc = sub.add_parser("validator_client", aliases=["vc"])
    vc.add_argument("--beacon-nodes", default="http://127.0.0.1:5052")
    vc.add_argument("--interop-validators", type=int, default=0)
    vc.add_argument("--slashing-db", default=":memory:")

    am = sub.add_parser("account_manager", aliases=["am", "account"])
    am_sub = am.add_subparsers(dest="am_cmd", required=True)
    am_new = am_sub.add_parser("validator_new")
    am_new.add_argument("--count", type=int, default=1)
    am_new.add_argument("--out", default="keystores")
    am_new.add_argument("--password", default="")
    am_wnew = am_sub.add_parser("wallet_new", help="EIP-2386 hd wallet")
    am_wnew.add_argument("--name", required=True)
    am_wnew.add_argument("--password", default="")
    am_wnew.add_argument("--wallet-dir", default="wallets")
    am_wlist = am_sub.add_parser("wallet_list")
    am_wlist.add_argument("--wallet-dir", default="wallets")
    am_vc = am_sub.add_parser("validator_create",
                              help="derive next validator from a wallet")
    am_vc.add_argument("--name", required=True)
    am_vc.add_argument("--password", default="")
    am_vc.add_argument("--keystore-password", default="")
    am_vc.add_argument("--wallet-dir", default="wallets")
    am_vc.add_argument("--out", default="keystores")

    bnode = sub.add_parser("boot_node", help="standalone discovery bootnode")
    bnode.add_argument("--host", default="127.0.0.1")
    bnode.add_argument("--boot-port", type=int, default=9100)

    dev = sub.add_parser("dev", help="lcli-style dev tools")
    dev_sub = dev.add_subparsers(dest="dev_cmd", required=True)
    tr = dev_sub.add_parser("transition-blocks")
    tr.add_argument("--pre", required=True, help="pre-state SSZ (fork byte"
                    " + state)")
    tr.add_argument("--block", required=True)
    tr.add_argument("--out", required=True)
    tr.add_argument("--no-signature-verification", action="store_true")
    sk = dev_sub.add_parser("skip-slots")
    sk.add_argument("--pre", required=True)
    sk.add_argument("--slots", type=int, required=True)
    sk.add_argument("--out", required=True)
    sr = dev_sub.add_parser("state-root")
    sr.add_argument("--state", required=True)
    br = dev_sub.add_parser("block-root")
    br.add_argument("--block", required=True)
    gi = dev_sub.add_parser("interop-genesis")
    gi.add_argument("--validators", type=int, default=64)
    gi.add_argument("--genesis-time", type=int, default=0)
    gi.add_argument("--out", required=True)

    dbm = sub.add_parser("database_manager", aliases=["db"])
    dbm.add_argument("--datadir", required=True)
    dbm_sub = dbm.add_subparsers(dest="db_cmd", required=True)
    dbm_sub.add_parser("version")
    dbm_sub.add_parser("inspect")
    dbm_sub.add_parser("compact")

    # validator_manager: bulk create/import/move (the reference's
    # validator_manager crate surface)
    vm = sub.add_parser("validator_manager", aliases=["vm"],
                        help="bulk validator lifecycle tooling")
    vm_sub = vm.add_subparsers(dest="vm_cmd", required=True)
    vm_create = vm_sub.add_parser("create",
                                  help="derive keystores from a seed")
    vm_create.add_argument("--seed-hex", required=True)
    vm_create.add_argument("--count", type=int, required=True)
    vm_create.add_argument("--first-index", type=int, default=0)
    vm_create.add_argument("--out-dir", required=True)
    vm_create.add_argument("--password", default="lighthouse-tpu")
    vm_import = vm_sub.add_parser("import",
                                  help="import keystores into a datadir")
    vm_import.add_argument("--keystore-dir", required=True)
    vm_import.add_argument("--password", default="lighthouse-tpu")
    vm_import.add_argument("--datadir", required=True)
    vm_move = vm_sub.add_parser(
        "move", help="move validators between datadirs w/ slashing history")
    vm_move.add_argument("--src-datadir", required=True)
    vm_move.add_argument("--dst-datadir", required=True)
    vm_move.add_argument("--keystore-dir", required=True,
                         help="dir holding the keystores to move")
    vm_move.add_argument("--password", default="lighthouse-tpu")
    vm_move.add_argument("--pubkeys", required=True,
                         help="comma-separated 0x pubkeys")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.testnet_dir:
        from .specs.networks import load_testnet_dir
        spec = load_testnet_dir(args.testnet_dir)
    else:
        from .specs.networks import network_spec
        spec = network_spec(args.network)

    if args.cmd in ("beacon_node", "bn", "beacon"):
        return _run_beacon_node(spec, args)
    if args.cmd in ("validator_client", "vc"):
        return _run_validator_client(spec, args)
    if args.cmd in ("account_manager", "am", "account"):
        return _run_account_manager(spec, args)
    if args.cmd in ("database_manager", "db"):
        return _run_database_manager(spec, args)
    if args.cmd == "dev":
        return _run_dev(spec, args)
    if args.cmd == "boot_node":
        from .network.discovery import main as boot_main
        return boot_main(["--host", args.host, "--port",
                          str(args.boot_port)])
    if args.cmd in ("validator_manager", "vm"):
        return _run_validator_manager(spec, args)
    return 1


def _run_validator_manager(spec, args):
    from . import validator_manager as vman
    from .validator_client import ValidatorStore

    def _store(datadir):
        import os
        from .validator_client import SlashingDatabase
        os.makedirs(datadir, exist_ok=True)
        db = SlashingDatabase(os.path.join(datadir,
                                           "slashing_protection.sqlite"))
        return ValidatorStore(spec, b"\x00" * 32, slashing_db=db)

    if args.vm_cmd == "create":
        out = vman.create_validators(
            bytes.fromhex(args.seed_hex.removeprefix("0x")), args.count,
            args.out_dir, args.password.encode(),
            first_index=args.first_index)
        print(f"created {len(out)} keystores in {args.out_dir}")
        return 0
    if args.vm_cmd == "import":
        store = _store(args.datadir)
        n = vman.import_validators(args.keystore_dir,
                                   args.password.encode(), store)
        print(f"imported {n} validators into {args.datadir}")
        return 0
    if args.vm_cmd == "move":
        src = _store(args.src_datadir)
        dst = _store(args.dst_datadir)
        # keys live in keystores, not the datadir: load them into the
        # source store first (the reference's move flow talks to a live
        # VC keymanager; the offline equivalent is keystore-dir + both
        # slashing databases)
        vman.import_validators(args.keystore_dir, args.password.encode(),
                               src)
        pubkeys = [bytes.fromhex(p.strip().removeprefix("0x"))
                   for p in args.pubkeys.split(",") if p.strip()]
        n = vman.move_validators(src, dst, pubkeys, b"\x00" * 32)
        print(f"moved {n} validators")
        return 0
    return 1


def _load_state(spec, path):
    from .containers import get_types
    from .containers.state import BeaconState
    from .specs.chain_spec import ForkName
    raw = open(path, "rb").read()
    return BeaconState.from_ssz_bytes(raw[1:], get_types(spec.preset), spec,
                                      ForkName(raw[0]))


def _dump_state(state, path):
    with open(path, "wb") as f:
        f.write(bytes([state.fork_name.value]) + state.serialize())


def _run_dev(spec, args):
    from .containers import get_types
    from .specs.chain_spec import ForkName
    from .ssz import deserialize, htr
    T = get_types(spec.preset)
    if args.dev_cmd == "transition-blocks":
        from .state_transition import per_block_processing, process_slots
        from .state_transition.block import VerifySignatures
        state = _load_state(spec, args.pre)
        braw = open(args.block, "rb").read()
        signed = deserialize(
            T.SignedBeaconBlock[ForkName(braw[0])].ssz_type, braw[1:])
        process_slots(state, signed.message.slot)
        per_block_processing(
            state, signed,
            VerifySignatures.FALSE if args.no_signature_verification
            else VerifySignatures.TRUE)
        _dump_state(state, args.out)
        print(json.dumps({"post_state_root":
                          "0x" + state.hash_tree_root().hex()}))
    elif args.dev_cmd == "skip-slots":
        from .state_transition import process_slots
        state = _load_state(spec, args.pre)
        process_slots(state, state.slot + args.slots)
        _dump_state(state, args.out)
        print(json.dumps({"slot": state.slot,
                          "state_root":
                          "0x" + state.hash_tree_root().hex()}))
    elif args.dev_cmd == "state-root":
        state = _load_state(spec, args.state)
        print(json.dumps({"slot": state.slot, "fork":
                          state.fork_name.name.lower(),
                          "root": "0x" + state.hash_tree_root().hex()}))
    elif args.dev_cmd == "block-root":
        braw = open(args.block, "rb").read()
        signed = deserialize(
            T.SignedBeaconBlock[ForkName(braw[0])].ssz_type, braw[1:])
        print(json.dumps({"slot": signed.message.slot,
                          "root": "0x" + htr(signed.message).hex()}))
    elif args.dev_cmd == "interop-genesis":
        from .crypto import bls
        from .state_transition import interop_genesis_state
        state = interop_genesis_state(
            spec, [bls.keygen_interop(i) for i in range(args.validators)],
            genesis_time=args.genesis_time)
        _dump_state(state, args.out)
        print(json.dumps({"validators": args.validators,
                          "genesis_validators_root":
                          "0x" + state.genesis_validators_root.hex()}))
    return 0


def _run_beacon_node(spec, args):
    from .client import ClientBuilder, Environment
    from .client.builder import ClientConfig
    from .network import NetworkConfig

    boot = []
    for hp in filter(None, args.boot_nodes.split(",")):
        host, _, port = hp.rpartition(":")
        boot.append((host or "127.0.0.1", int(port)))
    graffiti = args.graffiti.encode()[:32].ljust(32, b"\x00") \
        if args.graffiti else None
    fee_recipient = None
    if args.suggested_fee_recipient:
        try:
            fee_recipient = bytes.fromhex(
                args.suggested_fee_recipient.removeprefix("0x"))
        except ValueError:
            fee_recipient = b""
        if len(fee_recipient) != 20:
            print("error: --suggested-fee-recipient must be a 0x-prefixed"
                  " 20-byte hex address", file=sys.stderr)
            return 2
    monitor_pubkeys = [bytes.fromhex(p.strip().removeprefix("0x"))
                       for p in args.validator_monitor_pubkeys.split(",")
                       if p.strip()]
    cfg = ClientConfig(
        datadir=args.datadir, http_port=args.http_port,
        http_enabled=not args.disable_http,
        metrics_enabled=args.metrics, metrics_port=args.metrics_port,
        network=NetworkConfig(
            host=args.listen_address, port=args.port,
            target_peers=args.target_peers, boot_nodes=boot,
            upnp_enabled=args.upnp,
            subscribe_all_subnets=args.subscribe_all_subnets),
        discovery_port=args.discovery_port,
        graffiti=graffiti, suggested_fee_recipient=fee_recipient,
        snapshot_cache_size=args.snapshot_cache_size,
        reorg_threshold_pct=args.reorg_threshold,
        light_client_server=not args.disable_light_client_server,
        validator_monitor_pubkeys=monitor_pubkeys,
        purge_db=args.purge_db,
        slasher_enabled=args.slasher, crypto_backend=args.crypto_backend,
        interop_validator_count=args.interop_validators,
        genesis_time=args.genesis_time)
    if args.testnet_dir:
        from .specs.networks import testnet_genesis_state
        st = testnet_genesis_state(args.testnet_dir, spec)
        if st is not None:
            cfg.genesis_state = st
    if args.checkpoint_state:
        cfg.checkpoint_sync_state = open(args.checkpoint_state, "rb").read()
        if args.checkpoint_block:
            cfg.checkpoint_sync_block = \
                open(args.checkpoint_block, "rb").read()
    if args.dump_config:
        from .specs.networks import spec_to_config
        out = dict(vars(cfg))
        out["network"] = vars(cfg.network)
        out["spec"] = spec_to_config(spec)
        for k, v in out.items():
            if isinstance(v, bytes):
                out[k] = "0x" + v.hex()
            elif isinstance(v, list) and v and isinstance(v[0], bytes):
                out[k] = ["0x" + b.hex() for b in v]
        print(json.dumps(out, default=str))
        return 0
    env = Environment(args.log_level)
    client = ClientBuilder(spec, env).with_config(cfg).build()
    env.log.info("beacon node up: http=%s p2p=%s",
                 client.api_server.port if client.api_server else None,
                 client.network.port)
    reason = env.block_until_shutdown()
    env.log.info("shutting down: %s", reason)
    client.stop()
    return 0


def _run_validator_client(spec, args):
    import time as _time
    from .client import Environment
    from .crypto import bls
    from .validator_client import (
        BeaconNodeFallback, BeaconNodeHttpClient, SlashingDatabase,
        ValidatorClient, ValidatorStore,
    )
    env = Environment(args.log_level)
    clients = [BeaconNodeHttpClient(u.strip(), spec)
               for u in args.beacon_nodes.split(",") if u.strip()]
    nodes = BeaconNodeFallback(clients)
    genesis = clients[0]._req("GET", "/eth/v1/beacon/genesis")["data"]
    gvr = bytes.fromhex(genesis["genesis_validators_root"][2:])
    genesis_time = int(genesis["genesis_time"])
    store = ValidatorStore(spec, gvr, SlashingDatabase(args.slashing_db))
    for i in range(args.interop_validators):
        store.add_validator(bls.keygen_interop(i))
    vc = ValidatorClient(spec, store, nodes)
    env.log.info("validator client: %d keys, %d beacon nodes",
                 args.interop_validators, len(clients))

    def loop():
        last = -1
        while not env.shutdown_requested():
            slot = max(0, int(_time.time() - genesis_time)
                       // spec.seconds_per_slot)
            if slot != last and _time.time() >= genesis_time:
                last = slot
                try:
                    vc.on_slot(slot)
                except Exception:
                    env.log.exception("slot duties failed")
            _time.sleep(0.25)
    env.spawn(loop, "vc-loop")
    env.block_until_shutdown()
    return 0


def _run_account_manager(spec, args):
    import os
    from .crypto import bls
    from .crypto.keystore import create_keystore
    if args.am_cmd == "wallet_new":
        from .crypto.wallet import WalletManager
        wm = WalletManager(args.wallet_dir)
        w = wm.create(args.name, args.password.encode())
        print(json.dumps({"name": w.name, "uuid": w.data["uuid"]}))
        return 0
    if args.am_cmd == "wallet_list":
        from .crypto.wallet import WalletManager
        print(json.dumps(WalletManager(args.wallet_dir).list()))
        return 0
    if args.am_cmd == "validator_create":
        from .crypto.wallet import WalletManager
        wm = WalletManager(args.wallet_dir)
        w = wm.open(args.name)
        ks = w.next_validator_keystore(args.password.encode(),
                                       args.keystore_password.encode())
        wm.save(w)                     # persist the nextaccount bump
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"keystore-{ks['pubkey'][:12]}.json")
        with open(path, "w") as f:
            json.dump(ks, f, indent=2)
        print(f"wrote {path}")
        return 0
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.count):
        sk = bls.keygen_interop(i)
        pk = bls.sk_to_pk(sk)
        ks = create_keystore(sk, args.password.encode())
        path = os.path.join(args.out, f"keystore-{i}-{pk.hex()[:12]}.json")
        with open(path, "w") as f:
            json.dump(ks, f, indent=2)
        print(f"wrote {path}")
    return 0


def _run_database_manager(spec, args):
    from .store import HotColdDB, NativeKvStore
    import os
    db = HotColdDB(NativeKvStore(os.path.join(args.datadir, "chain_db")),
                   NativeKvStore(os.path.join(args.datadir, "freezer_db")),
                   spec)
    if args.db_cmd == "version":
        print(json.dumps({"schema_version": db.schema_version()}))
    elif args.db_cmd == "inspect":
        print(json.dumps({"split_slot": db.split.slot,
                          "hot_keys": len(db.hot) if hasattr(
                              db.hot, "__len__") else -1}))
    elif args.db_cmd == "compact":
        db.hot.compact()
        db.cold.compact()
        print("compacted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
