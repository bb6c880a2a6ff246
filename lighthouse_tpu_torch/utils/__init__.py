from .hash import sha256, hash_concat, ZERO_HASHES
