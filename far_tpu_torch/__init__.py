"""far_tpu_torch: the PyTorch + CUDA port of far_tpu, for NVIDIA Hopper.

Mirrors ``far_tpu``'s layout. It imports torch, numpy and the standard
library, never JAX or ``far_tpu``. Each TPU kernel of ``far_tpu/ops`` has
a hand-written CUDA counterpart under ``csrc/`` with a plain PyTorch
version beside it in ``ops/``.
"""
