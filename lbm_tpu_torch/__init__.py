"""lbm_tpu_torch: the PyTorch + CUDA port of lbm_tpu for NVIDIA Hopper.

Same ``(9, R, C)`` planes layout and module names as ``lbm_tpu``; plain
PyTorch functions are the reference, and the per-step hot paths run as
hand-written CUDA kernels (``csrc/``) when the state lies on a CUDA
device.  Importing this package never imports JAX.
"""

import torch

# The moment sums are explicit 9-term sums (no matmul, no convolution), but
# TF32 is pinned off all the same: a float32 contraction added later must not
# silently drop to ~3 decimal digits (the torch counterpart of the bf16 trap
# described in lbm_tpu/utils/xmath.py).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
