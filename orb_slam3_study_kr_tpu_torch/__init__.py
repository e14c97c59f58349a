"""PyTorch + CUDA port of the monocular SLAM main path of
``orb_slam3_study_kr_tpu``.

The JAX package beside this one is the reference; this package imports
``torch`` and never ``jax``.  Layer tree and module names mirror the
reference package (lie/, cameras/, ops/, solvers/, slam_map/, pipeline/,
io/, evaluation/, utils/, native/).  The two Pallas kernels on the main
path are hand-written CUDA C++ for Hopper under ``csrc/`` (built with nvcc
at first use); every kernel wrapper runs its plain PyTorch version when
handed a CPU tensor.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry accuracy is load-bearing (depth/baseline ratios amplify input
# rounding into percent-level 3-D error): keep every float32 matmul and
# convolution in full float32, the reference package's f32 contract.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
