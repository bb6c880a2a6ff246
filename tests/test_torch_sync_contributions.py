"""SignedContributionAndProof verification + pooling (the gossip
aggregate path of sync_committee_verification.rs) and its HTTP route.

The whole harness runs under REAL crypto (native C++ backend when it
builds, python oracle otherwise), so the selection proof, aggregator
signature, and aggregate contribution signature are genuinely checked.

The same cases as the JAX package's tests/test_sync_contributions.py, run on the port
(imports switched to lighthouse_tpu_torch; the port on the CPU, its BLS
backend put back after the module).
"""
import pytest

from lighthouse_tpu_torch.chain import BeaconChainHarness
from lighthouse_tpu_torch.chain.errors import AttestationError
from lighthouse_tpu_torch.crypto import bls
from lighthouse_tpu_torch.specs import minimal_spec
from lighthouse_tpu_torch.specs.constants import (
    DOMAIN_CONTRIBUTION_AND_PROOF, DOMAIN_SYNC_COMMITTEE,
    DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
    TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE,
)
from lighthouse_tpu_torch.specs.chain_spec import compute_signing_root
from lighthouse_tpu_torch.ssz import htr
from lighthouse_tpu_torch.state_transition.helpers import get_domain
from lighthouse_tpu_torch.utils.hash import sha256
from lighthouse_tpu_torch.device import set_device


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    prev, saved = set_device("cpu"), bls._current
    yield
    bls._current = saved
    set_device(prev)


def _real_backend():
    """Real crypto: the native C++ backend when it builds, else the
    python oracle (byte-compatible)."""
    try:
        return bls.set_backend("cpp")
    except Exception:
        return bls.set_backend("python")


def _altair_harness(n_validators=16):
    """Whole harness under REAL crypto, so state pubkeys correspond to
    the interop secret keys the test signs with."""
    _real_backend()
    spec = minimal_spec(altair_fork_epoch=0)
    h = BeaconChainHarness(spec, n_validators)
    h.extend_chain(2)
    return h


def _build_contribution(h, subcommittee=0, n_signers=2):
    """A genuinely-signed SignedContributionAndProof from the first
    aggregator-eligible validator."""
    T = h.T
    chain = h.chain
    state = chain.head().head_state
    slot = int(state.slot)
    root = chain.head().head_block_root
    epoch = slot // state.slots_per_epoch
    committee = state.current_sync_committee
    size = chain.spec.preset.sync_committee_size
    sub_size = size // 4
    start = subcommittee * sub_size
    pk_to_index = {state.validators.pubkey(i): i
                   for i in range(len(state.validators))}

    # sign sync messages for the first n_signers positions of the subnet
    sc_domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch)
    sc_root = compute_signing_root(root, sc_domain)
    bits, sigs = [], []
    for j in range(sub_size):
        vidx = pk_to_index[bytes(committee.pubkeys[start + j])]
        if j < n_signers:
            bits.append(True)
            sigs.append(bls.sign(h.secret_keys[vidx], sc_root))
        else:
            bits.append(False)
    contrib = T.SyncCommitteeContribution(
        slot=slot, beacon_block_root=root,
        subcommittee_index=subcommittee, aggregation_bits=bits,
        signature=bls.aggregate_signatures(sigs))

    # find an aggregator whose selection proof passes the modulo
    sel_domain = get_domain(state, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
                            epoch)
    sel_root = compute_signing_root(
        htr(T.SyncAggregatorSelectionData(
            slot=slot, subcommittee_index=subcommittee)), sel_domain)
    modulo = max(1, sub_size // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE)
    for vidx in range(len(state.validators)):
        proof = bls.sign(h.secret_keys[vidx], sel_root)
        if int.from_bytes(sha256(proof)[:8], "little") % modulo == 0:
            break
    else:
        pytest.skip("no eligible aggregator (modulo)")
    msg = T.ContributionAndProof(
        aggregator_index=vidx, contribution=contrib,
        selection_proof=proof)
    cp_domain = get_domain(state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
    agg_sig = bls.sign(h.secret_keys[vidx],
                       compute_signing_root(htr(msg), cp_domain))
    return T.SignedContributionAndProof(message=msg, signature=agg_sig), \
        slot, root


def test_contribution_verify_pool_and_aggregate():
    h = _altair_harness()
    try:
        signed, slot, root = _build_contribution(h, subcommittee=0,
                                                 n_signers=3)
        pool = h.chain.sync_committee_pool
        assert pool.verify_and_add_contribution(signed) == 3
        # the pooled contribution feeds the next block's SyncAggregate
        agg = pool.produce_sync_aggregate(slot, root)
        assert sum(1 for b in agg.sync_committee_bits if b) == 3
        # tampered aggregator signature is rejected
        bad = h.T.SignedContributionAndProof(
            message=signed.message, signature=b"\xaa" + bytes(
                signed.signature)[1:])
        with pytest.raises(AttestationError):
            pool.verify_and_add_contribution(bad)
        # wrong-bits contribution (sig no longer matches) is rejected
        c = signed.message.contribution
        flipped = list(c.aggregation_bits)
        flipped[-1] = not flipped[-1]
        bad_contrib = h.T.SyncCommitteeContribution(
            slot=c.slot, beacon_block_root=c.beacon_block_root,
            subcommittee_index=c.subcommittee_index,
            aggregation_bits=flipped, signature=c.signature)
        bad_msg = h.T.ContributionAndProof(
            aggregator_index=signed.message.aggregator_index,
            contribution=bad_contrib,
            selection_proof=signed.message.selection_proof)
        state = h.chain.head().head_state
        cp_domain = get_domain(state, DOMAIN_CONTRIBUTION_AND_PROOF,
                               int(state.slot) // state.slots_per_epoch)
        sig = bls.sign(h.secret_keys[int(signed.message.aggregator_index)],
                       compute_signing_root(htr(bad_msg), cp_domain))
        with pytest.raises(AttestationError):
            pool.verify_and_add_contribution(
                h.T.SignedContributionAndProof(message=bad_msg,
                                               signature=sig))
    finally:
        bls.set_backend("fake")


def test_contribution_http_route():
    h = _altair_harness()
    try:
        signed, slot, root = _build_contribution(h, subcommittee=1,
                                                 n_signers=2)
        from lighthouse_tpu_torch.api import ApiBackend, BeaconApiServer
        from lighthouse_tpu_torch.ssz import serialize
        import urllib.request
        srv = BeaconApiServer(ApiBackend(h.chain))
        srv.start()
        try:
            body = serialize(type(signed).ssz_type, signed)
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}"
                f"/eth/v1/validator/contribution_and_proofs",
                data=body, method="POST")
            with urllib.request.urlopen(req) as r:
                assert r.status == 200
            agg = h.chain.sync_committee_pool.produce_sync_aggregate(
                slot, root)
            assert sum(1 for b in agg.sync_committee_bits if b) == 2
        finally:
            srv.stop()
    finally:
        bls.set_backend("fake")
