"""lighthouse_tpu_torch — the PyTorch/CUDA port of lighthouse_tpu.

The device layer (ops/) runs hand-written CUDA kernels (csrc/, built and
bound by kernels.py) on an NVIDIA Hopper card; the host layers are copies
of the JAX package's jax-free modules bound to the port's own ops/.
Importing the package touches no CUDA: the device is chosen at call time
(device.py) and the kernels build at their first launch.
"""
