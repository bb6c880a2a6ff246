"""Crypto layer (L0): BLS12-381, KZG, SHA-256, keystores.

Equivalent of sigp/lighthouse crypto/* with the backend-generic design of
crypto/bls/src/lib.rs:86-141: every verification site funnels through
``bls.verify_signature_sets`` so the whole client's signature load hits one
batched choke point — which is exactly what maps onto the card.
"""
