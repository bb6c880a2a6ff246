"""Device kernels of the port: SHA-256 and the incremental merkle tree."""
