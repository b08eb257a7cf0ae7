"""PyTorch / CUDA port of ``alink_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``alink_tpu``'s layout and public names; the JAX
package stays the reference it is tested against.  It imports ``torch``
and never ``jax``.  The CUDA kernels (``csrc/``) are built by ``nvcc`` at
first use on a CUDA tensor (``_build.py``); CPU tensors take each
kernel's plain PyTorch version.

TF32 is off for both matmuls and cuDNN convolutions: pixel coordinates and
interpolation weights must never pass through a 10-bit-mantissa product,
and the f32 paths are held to the JAX package's f32 results.  The towers
that are meant to be fast run in bf16, which the flags do not touch.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
