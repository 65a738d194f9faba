"""mcpt_tpu_torch — the PyTorch/CUDA port of the mcpt_tpu path tracer.

Same layer map as `mcpt_tpu` (ops/, models/, scene/, integrators/,
render/), written as plain functions on torch tensors with an explicit
`device` argument.  Entry points run on "cuda" unless the caller passes
device="cpu".  The ray traversal kernels are CUDA written by hand
(csrc/: the dense sweep, the block march, the corridor and the pair
sweep, built by `mcpt_tpu_torch.build`); on CPU tensors their plain
PyTorch versions run instead.

The package imports neither JAX nor `mcpt_tpu`: the JAX package is the
reference the tests hold this one against, not a dependency.
"""

import torch

__version__ = "0.1.0"

# Renderer numerics need true-f32 contractions (the counterpart of
# mcpt_tpu/__init__.py's pinned float32 matmul precision): TF32 keeps
# ~3 decimal digits, which would quantize transforms and table selects.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
