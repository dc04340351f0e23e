"""salient_plusplus_tpu_torch — the PyTorch/CUDA port of salient_plusplus_tpu.

A second package beside the JAX one, which stays the reference: the same
host C++ sampler and padded, wire-packed batches, the same config and data
contract, PyTorch modules around hand-written CUDA kernels for Hopper
(``csrc/``). It trains the model zoo on one card through the driver CLI,
with the whole feature table on the card or its cold tail in host RAM;
ROADMAP.md lists what follows. Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
