"""Per-flag round-trip tests for the beacon_node CLI, in the style of
lighthouse/tests/beacon_node.rs: every flag the parser exposes is set to
a non-default value, the node is run with --dump-config, and the dumped
config must reflect it.  A completeness gate fails the suite when a new
flag is added without a mapping here — "every flag documented in --help
lands in the dumped config".

The cases of the JAX package's tests/test_cli_flags.py, run on the port's
command line (imports switched to lighthouse_tpu_torch; the port on the
CPU)."""
from __future__ import annotations

import json

import pytest

from lighthouse_tpu_torch.__main__ import build_parser, main
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _bn_parser():
    parser = build_parser()
    for action in parser._subparsers._group_actions:
        return action.choices["beacon_node"]
    raise AssertionError("no subparsers")


def _dump(argv, capsys):
    rc = main(["beacon_node", *argv, "--dump-config"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# flag -> (argv values, extractor, expected dumped value); None = the
# flag is dump-exempt (it controls dumping itself or reads a file whose
# content lands elsewhere)
FLAG_CASES = {
    "--datadir": (["/tmp/lhtpu-dd"], lambda d: d["datadir"],
                  "/tmp/lhtpu-dd"),
    "--http-port": (["5999"], lambda d: d["http_port"], 5999),
    "--disable-http": ([], lambda d: d["http_enabled"], False),
    "--metrics": ([], lambda d: d["metrics_enabled"], True),
    "--metrics-port": (["5111"], lambda d: d["metrics_port"], 5111),
    "--listen-address": (["0.0.0.0"], lambda d: d["network"]["host"],
                         "0.0.0.0"),
    "--target-peers": (["42"], lambda d: d["network"]["target_peers"],
                       42),
    "--discovery-port": (["9123"], lambda d: d["discovery_port"], 9123),
    "--upnp": ([], lambda d: d["network"]["upnp_enabled"], True),
    "--subscribe-all-subnets": (
        [], lambda d: d["network"]["subscribe_all_subnets"], True),
    "--graffiti": (["hi"], lambda d: d["graffiti"],
                   "0x" + b"hi".ljust(32, b"\x00").hex()),
    "--suggested-fee-recipient": (
        ["0x" + "ab" * 20], lambda d: d["suggested_fee_recipient"],
        "0x" + "ab" * 20),
    "--snapshot-cache-size": (["4"], lambda d: d["snapshot_cache_size"],
                              4),
    "--reorg-threshold": (["33"], lambda d: d["reorg_threshold_pct"], 33),
    "--disable-light-client-server": (
        [], lambda d: d["light_client_server"], False),
    "--validator-monitor-pubkeys": (
        ["0x" + "cd" * 48], lambda d: d["validator_monitor_pubkeys"],
        ["0x" + "cd" * 48]),
    "--purge-db": ([], lambda d: d["purge_db"], True),
    "--port": (["9777"], lambda d: d["network"]["port"], 9777),
    "--boot-nodes": (["10.0.0.1:9000"],
                     lambda d: d["network"]["boot_nodes"],
                     [["10.0.0.1", 9000]]),
    "--slasher": ([], lambda d: d["slasher_enabled"], True),
    "--crypto-backend": (["fake"], lambda d: d["crypto_backend"], "fake"),
    "--interop-validators": (["8"],
                             lambda d: d["interop_validator_count"], 8),
    "--genesis-time": (["12345"], lambda d: d["genesis_time"], 12345),
    "--checkpoint-state": None,       # reads a file into bytes fields
    "--checkpoint-block": None,
    "--dump-config": None,            # the dump switch itself
    "--help": None,
}


def test_every_bn_flag_has_a_roundtrip_case():
    """Completeness gate: adding a flag without a dump mapping fails."""
    bn = _bn_parser()
    flags = {opt for a in bn._actions for opt in a.option_strings
             if opt.startswith("--")}
    missing = flags - set(FLAG_CASES)
    assert not missing, f"flags without round-trip cases: {missing}"


@pytest.mark.parametrize("flag", [f for f, c in FLAG_CASES.items()
                                  if c is not None])
def test_bn_flag_lands_in_dumped_config(flag, capsys):
    values, extract, want = FLAG_CASES[flag]
    dumped = _dump([flag, *values], capsys)
    assert extract(dumped) == want, flag


def test_checkpoint_state_flag_loads_bytes(tmp_path, capsys):
    p = tmp_path / "cp.ssz"
    p.write_bytes(b"\x01" + b"\xee" * 64)
    dumped = _dump(["--checkpoint-state", str(p)], capsys)
    assert dumped["checkpoint_sync_state"] == \
        "0x" + (b"\x01" + b"\xee" * 64).hex()


def test_defaults_dump_clean(capsys):
    d = _dump([], capsys)
    assert d["http_enabled"] is True
    assert d["network"]["upnp_enabled"] is False
    assert d["graffiti"] is None
    assert d["spec"]["PRESET_BASE"] == "minimal"
