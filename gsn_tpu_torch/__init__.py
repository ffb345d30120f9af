"""gsn_tpu_torch — the PyTorch/CUDA port of gsn_tpu.

Graph Substructure Networks (arXiv:2006.09252) on an NVIDIA Hopper card:
the same host-side counting, encoding and batching as ``gsn_tpu`` (kept
as copies here, so this package imports no JAX), PyTorch modules for the
model, and hand-written CUDA kernels in place of the TPU's Pallas ones
(``gsn_tpu_torch/csrc``, bound in ``gsn_tpu_torch/ops/cuda``).
"""

__version__ = "0.1.0"
