"""The port's command line (``python -m lighthouse_tpu_torch``) against the
JAX package's, tolerance zero: both packages' ``main([...])`` run
in-process on ``--network minimal`` (each on its own ``ChainSpec``), the
port on the CPU, both BLS backends on ``cpp``. The ``dev`` subcommands
write the same files and print the same JSON; ``transition-blocks`` runs a
block from both packages' ``BeaconChainHarness`` with signatures on and
off. The parsers offer the same subcommands and flags but for the crypto
backend, whose choices and default are the port's ``gpu``."""
import json
import os
import subprocess
import sys

import pytest

from lighthouse_tpu import __main__ as jcli
from lighthouse_tpu.chain import BeaconChainHarness as JHarness
from lighthouse_tpu.crypto import bls as jbls
from lighthouse_tpu.specs.networks import network_spec as j_network_spec
from lighthouse_tpu.ssz import serialize as j_serialize
from lighthouse_tpu_torch import __main__ as cli
from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.device import set_device
from lighthouse_tpu_torch.specs.networks import network_spec
from lighthouse_tpu_torch.ssz import serialize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALIDATORS = 64


@pytest.fixture(autouse=True)
def cpu_cpp():
    prev = set_device("cpu")
    saved = bls._current, jbls._current
    bls.set_backend("cpp")
    jbls.set_backend("cpp")
    yield
    bls._current, jbls._current = saved
    set_device(prev)


def _run_both(capsys, tmp_path, argv: list[str]) -> tuple:
    """Each package's ``main`` on ``argv`` with ``{out}`` naming a file of
    its own directory; returns (stdout, file bytes or None) per package."""
    outs = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        args = [a.format(out=d / "out.ssz", dir=d) for a in argv]
        assert main(["--network", "minimal", *args]) == 0
        out = capsys.readouterr().out
        path = d / "out.ssz"
        outs.append((out, path.read_bytes() if path.exists() else None))
    return outs


def test_dev_interop_genesis_skip_slots_and_roots_byte_equal(capsys,
                                                             tmp_path):
    got, want = _run_both(capsys, tmp_path, [
        "dev", "interop-genesis", "--validators", str(VALIDATORS),
        "--genesis-time", "1606824023", "--out", "{out}"])
    assert got == want
    assert json.loads(got[0])["validators"] == VALIDATORS
    for name in ("port", "jax"):
        (tmp_path / name / "genesis.ssz").write_bytes(got[1])
    got, want = _run_both(capsys, tmp_path, [
        "dev", "skip-slots", "--pre", "{dir}/genesis.ssz", "--slots", "11",
        "--out", "{out}"])
    assert got == want and json.loads(got[0])["slot"] == 11
    for name in ("port", "jax"):
        (tmp_path / name / "skipped.ssz").write_bytes(got[1])
    for state in ("genesis.ssz", "skipped.ssz"):
        got, want = _run_both(capsys, tmp_path, [
            "dev", "state-root", "--state", "{dir}/" + state])
        assert got == want


def _harness_block(tmp_path):
    """The same pre-state and signed block from both packages' harness
    (interop keys, signed on cpp), written as fork byte + SSZ into each
    package's directory."""
    spec, jspec = network_spec("minimal"), j_network_spec("minimal")
    h, jh = BeaconChainHarness(spec, VALIDATORS), JHarness(jspec, VALIDATORS)
    assert h.extend_chain(3) == jh.extend_chain(3)
    for name, harness, ser in (("port", h, serialize), ("jax", jh,
                                                        j_serialize)):
        pre = harness.chain.head().head_state.copy()
        harness.advance_slot()
        signed, _post = harness.produce_signed_block()
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        (d / "pre.ssz").write_bytes(bytes([pre.fork_name.value])
                                    + pre.serialize())
        (d / "block.ssz").write_bytes(
            bytes([pre.fork_name.value])
            + ser(type(signed).ssz_type, signed))
    assert (tmp_path / "port" / "pre.ssz").read_bytes() == \
        (tmp_path / "jax" / "pre.ssz").read_bytes()
    assert (tmp_path / "port" / "block.ssz").read_bytes() == \
        (tmp_path / "jax" / "block.ssz").read_bytes()


@pytest.mark.parametrize("signatures", [True, False])
def test_dev_transition_blocks_byte_equal(capsys, tmp_path, signatures):
    _harness_block(tmp_path)
    argv = ["dev", "transition-blocks", "--pre", "{dir}/pre.ssz",
            "--block", "{dir}/block.ssz", "--out", "{out}"]
    if not signatures:
        argv.append("--no-signature-verification")
    got, want = _run_both(capsys, tmp_path, argv)
    assert got == want
    assert json.loads(got[0])["post_state_root"].startswith("0x")
    got, want = _run_both(capsys, tmp_path, [
        "dev", "block-root", "--block", "{dir}/block.ssz"])
    assert got == want


def test_dev_transition_blocks_refuses_a_bad_signature_in_both(capsys,
                                                             tmp_path):
    """A block whose proposal signature is the point at infinity: both
    packages raise the same error with signatures on, and write the same
    post-state with them off."""
    _harness_block(tmp_path)
    for name in ("port", "jax"):
        d = tmp_path / name
        raw = bytearray((d / "block.ssz").read_bytes())
        # fork byte, the message's 4-byte offset, then the signature: the
        # point at infinity
        raw[5:101] = bytes([0xC0]) + bytes(95)
        (d / "bad.ssz").write_bytes(bytes(raw))
    errors = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / name
        with pytest.raises(Exception) as e:
            main(["--network", "minimal", "dev", "transition-blocks",
                  "--pre", str(d / "pre.ssz"), "--block", str(d / "bad.ssz"),
                  "--out", str(d / "post.ssz")])
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    got, want = _run_both(capsys, tmp_path, [
        "dev", "transition-blocks", "--pre", "{dir}/pre.ssz", "--block",
        "{dir}/bad.ssz", "--out", "{out}", "--no-signature-verification"])
    assert got == want


def _tree(parser) -> dict:
    """Every subcommand path's flags: option strings, default, choices."""
    import argparse
    out = {}

    def walk(p, path):
        flags = {}
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sub in a.choices.items():
                    walk(sub, path + (name,))
            elif a.option_strings:
                flags[tuple(a.option_strings)] = (
                    None if a.default is argparse.SUPPRESS else a.default,
                    tuple(a.choices) if a.choices else None)
        out[path] = flags

    walk(parser, ())
    return out


def test_parser_subcommands_and_flags_equal_but_the_backend():
    got, want = _tree(cli.build_parser()), _tree(jcli.build_parser())
    assert got.keys() == want.keys()
    key = ("--crypto-backend",)
    for path in ("beacon_node", "bn", "beacon"):
        assert got[(path,)][key] == ("gpu", ("python", "fake", "gpu", "cpp"))
        assert want[(path,)][key] == ("python", ("python", "fake", "tpu",
                                                 "cpp"))
        del got[(path,)][key], want[(path,)][key]
    assert got == want
    assert cli.build_parser().prog == "lighthouse_tpu_torch"


def test_bn_dump_config_default_backend_gpu(capsys):
    for main in (cli.main, jcli.main):
        assert main(["--network", "minimal", "bn", "--dump-config",
                     "--interop-validators", "8"]) == 0
    got, want = (json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines())
    assert got.pop("crypto_backend") == "gpu"
    assert want.pop("crypto_backend") == "python"
    assert got == want


def test_module_help_loads_neither_jax_nor_the_jax_package():
    """``python -m lighthouse_tpu_torch --help`` in a process of its own."""
    probe = ("import runpy, sys\n"
             "sys.argv = ['lighthouse_tpu_torch', '--help']\n"
             "try:\n"
             "    runpy.run_module('lighthouse_tpu_torch', "
             "run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert e.code == 0, e.code\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'lighthouse_tpu')]\n"
             "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage: lighthouse_tpu_torch" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "BAD []"
