"""ValidatorStore: the signing facade gated by slashing protection.

Equivalent of the reference's validator_client/src/validator_store.rs:61 and
signing_method.rs:80-95 (LocalKeystore; Web3Signer slot kept as an interface).
"""
from __future__ import annotations

from ..crypto import bls
from ..specs.chain_spec import ChainSpec, compute_domain, compute_signing_root
from ..specs.constants import (
    DOMAIN_AGGREGATE_AND_PROOF, DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER, DOMAIN_RANDAO, DOMAIN_SELECTION_PROOF,
    DOMAIN_SYNC_COMMITTEE, DOMAIN_VOLUNTARY_EXIT,
)
from ..ssz import hash_tree_root, htr, uint64
from .slashing_protection import SlashingDatabase, SlashingError


class SigningMethod:
    LOCAL_KEYSTORE = "local_keystore"
    WEB3SIGNER = "web3signer"


class ValidatorStore:
    def __init__(self, spec: ChainSpec, genesis_validators_root: bytes,
                 slashing_db: SlashingDatabase | None = None):
        self.spec = spec
        self.genesis_validators_root = genesis_validators_root
        self.slashing_db = slashing_db or SlashingDatabase()
        self._keys: dict[bytes, int] = {}  # pubkey -> sk
        self._fork_version = spec.genesis_fork_version

    def add_validator(self, sk: int) -> bytes:
        pk = bls.sk_to_pk(sk)
        self._keys[pk] = sk
        self.slashing_db.register_validator(pk)
        return pk

    def add_remote_validator(self, pubkey: bytes, url: str) -> None:
        """Web3Signer-backed key: only the URL is held locally
        (signing_method.rs remote path); slashing protection stays here."""
        if not hasattr(self, "_remote_keys"):
            self._remote_keys: dict[bytes, str] = {}
        self._remote_keys[pubkey] = url
        self.slashing_db.register_validator(pubkey)

    def remove_remote_validator(self, pubkey: bytes) -> None:
        getattr(self, "_remote_keys", {}).pop(pubkey, None)

    def voting_pubkeys(self) -> list[bytes]:
        return list(self._keys) + list(getattr(self, "_remote_keys", {}))

    def set_fork_version(self, version: bytes) -> None:
        self._fork_version = version

    def _domain(self, domain_type: int) -> bytes:
        return compute_domain(domain_type, self._fork_version,
                              self.genesis_validators_root)

    def _sign(self, pubkey: bytes, signing_root: bytes) -> bytes:
        sk = self._keys.get(pubkey)
        if sk is not None:
            return bls.sign(sk, signing_root)
        url = getattr(self, "_remote_keys", {}).get(pubkey)
        if url is not None:
            from .remote_signer import remote_sign
            return remote_sign(url, pubkey, signing_root)
        raise SlashingError("unknown validator key")

    # -- gated signing -------------------------------------------------------

    def sign_block(self, pubkey: bytes, block) -> bytes:
        domain = self._domain(DOMAIN_BEACON_PROPOSER)
        signing_root = compute_signing_root(htr(block), domain)
        self.slashing_db.check_and_insert_block_proposal(
            pubkey, block.slot, signing_root)
        return self._sign(pubkey, signing_root)

    def sign_attestation(self, pubkey: bytes, data) -> bytes:
        domain = self._domain(DOMAIN_BEACON_ATTESTER)
        signing_root = compute_signing_root(htr(data), domain)
        self.slashing_db.check_and_insert_attestation(
            pubkey, data.source.epoch, data.target.epoch, signing_root)
        return self._sign(pubkey, signing_root)

    # -- ungated signing (not slashable) -------------------------------------

    def sign_validator_registration(self, pubkey: bytes,
                                    message: dict) -> bytes:
        """Builder-specs SignedValidatorRegistration (signing_method.rs
        builder path).  Domain uses the GENESIS fork version and a zero
        genesis_validators_root per the builder specs."""
        import hashlib
        from ..specs.constants import DOMAIN_APPLICATION_BUILDER
        domain = compute_domain(DOMAIN_APPLICATION_BUILDER,
                                self.spec.genesis_fork_version, b"\x00" * 32)
        # miniature registration root: no dedicated SSZ container type —
        # a canonical field hash stands in (mock builder checks bytes only)
        root = hashlib.sha256(
            bytes.fromhex(message["fee_recipient"][2:])
            + int(message["gas_limit"]).to_bytes(8, "little")
            + int(message["timestamp"]).to_bytes(8, "little")
            + bytes.fromhex(message["pubkey"][2:])).digest()
        return self._sign(pubkey, compute_signing_root(root, domain))

    def randao_reveal(self, pubkey: bytes, epoch: int) -> bytes:
        domain = self._domain(DOMAIN_RANDAO)
        return self._sign(pubkey, compute_signing_root(
            hash_tree_root(uint64, epoch), domain))

    def selection_proof(self, pubkey: bytes, slot: int) -> bytes:
        domain = self._domain(DOMAIN_SELECTION_PROOF)
        return self._sign(pubkey, compute_signing_root(
            hash_tree_root(uint64, slot), domain))

    def sign_aggregate_and_proof(self, pubkey: bytes, message) -> bytes:
        domain = self._domain(DOMAIN_AGGREGATE_AND_PROOF)
        return self._sign(pubkey, compute_signing_root(htr(message), domain))

    def sign_voluntary_exit(self, pubkey: bytes, exit_message) -> bytes:
        domain = self._domain(DOMAIN_VOLUNTARY_EXIT)
        return self._sign(pubkey, compute_signing_root(htr(exit_message),
                                                       domain))

    def sign_sync_committee_message(self, pubkey: bytes,
                                    block_root: bytes) -> bytes:
        domain = self._domain(DOMAIN_SYNC_COMMITTEE)
        return self._sign(pubkey, compute_signing_root(block_root, domain))
