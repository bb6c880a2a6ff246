"""Test utilities: the state harness, and support code that only the
port's tests run (``host_cuda``, ``ranks``).

``StateHarness`` is the state-transition core of the reference's
BeaconChainHarness (beacon_chain/src/test_utils.rs:611): deterministic
interop keys, blocks with full attestation participation.
"""
from .state_harness import StateHarness
