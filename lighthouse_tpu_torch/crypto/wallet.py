"""EIP-2386 hierarchical deterministic wallet (crypto/eth2_wallet).

A wallet wraps an encrypted EIP-2333 seed plus a `nextaccount` counter;
validator keys derive at the EIP-2334 paths m/12381/3600/{i}/0/0
(voting) and m/12381/3600/{i}/0 (withdrawal).  The seed is encrypted
with the same scrypt+AES-128-CTR construction as EIP-2335 keystores
(crypto/keystore.py), as the reference's `hd` wallet type does
(ref: crypto/eth2_wallet, account_manager/src/wallet).
"""
from __future__ import annotations

import json
import os
import uuid as uuidlib

from .key_derivation import derive_path
from .keystore import create_keystore, decrypt_secret, encrypt_secret


def create_wallet(name: str, password: bytes,
                  seed: bytes | None = None) -> dict:
    """New EIP-2386 wallet JSON (type 'hd')."""
    seed = seed if seed is not None else os.urandom(32)
    crypto = encrypt_secret(seed, password)
    return {
        "crypto": crypto,
        "name": name,
        "nextaccount": 0,
        "type": "hd",
        "uuid": str(uuidlib.uuid4()),
        "version": 1,
    }


def decrypt_seed(wallet: dict, password: bytes) -> bytes:
    return decrypt_secret(wallet["crypto"], password)


class Wallet:
    """Operational wrapper: derive the next validator, produce keystores."""

    def __init__(self, data: dict):
        self.data = data

    @classmethod
    def create(cls, name: str, password: bytes,
               seed: bytes | None = None) -> "Wallet":
        return cls(create_wallet(name, password, seed))

    @classmethod
    def from_json(cls, data: dict) -> "Wallet":
        if data.get("type") != "hd" or data.get("version") != 1:
            raise ValueError("unsupported wallet type/version")
        return cls(data)

    @property
    def name(self) -> str:
        return self.data["name"]

    @property
    def nextaccount(self) -> int:
        return self.data["nextaccount"]

    def derive_validator(self, password: bytes,
                         index: int | None = None) -> tuple[int, int, int]:
        """Returns (account_index, voting_sk, withdrawal_sk); advances
        `nextaccount` when deriving the next sequential account."""
        seed = decrypt_seed(self.data, password)
        i = index if index is not None else self.data["nextaccount"]
        voting = derive_path(seed, f"m/12381/3600/{i}/0/0")
        withdrawal = derive_path(seed, f"m/12381/3600/{i}/0")
        if index is None:
            self.data["nextaccount"] = i + 1
        return i, voting, withdrawal

    def next_validator_keystore(self, wallet_password: bytes,
                                keystore_password: bytes) -> dict:
        """Derive the next account and wrap its voting key in an
        EIP-2335 keystore (the account_manager `validator create` flow)."""
        i, voting, _withdrawal = self.derive_validator(wallet_password)
        ks = create_keystore(voting, keystore_password,
                             path=f"m/12381/3600/{i}/0/0")
        return ks


class WalletManager:
    """Directory-of-wallets CRUD (account_manager/src/wallet)."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.base_dir, f"{name}.json")

    def create(self, name: str, password: bytes) -> Wallet:
        if os.path.exists(self._path(name)):
            raise FileExistsError(f"wallet {name!r} exists")
        w = Wallet.create(name, password)
        self.save(w)
        return w

    def open(self, name: str) -> Wallet:
        with open(self._path(name)) as f:
            return Wallet.from_json(json.load(f))

    def save(self, w: Wallet) -> None:
        with open(self._path(w.name), "w") as f:
            json.dump(w.data, f, indent=2)

    def list(self) -> list[str]:
        return sorted(f[:-5] for f in os.listdir(self.base_dir)
                      if f.endswith(".json"))
