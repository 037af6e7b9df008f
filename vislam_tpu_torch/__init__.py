"""vislam_tpu_torch — the PyTorch/CUDA port of vislam_tpu.

The JAX package `vislam_tpu` stays the reference; this package mirrors its
layout module for module and runs the per-frame VIO step (GT scale, or
GT-free with the VI alignment, open loop or with the in-step window VI-BA
of SLAM mode) on an NVIDIA Hopper card, with every frontend of the
reference but the oriented descriptor: the Gaussian or nonlinear (KAZE/AKAZE) scale space,
the five detector families, SIFT or BRIEF descriptors. Plain tensor code
is PyTorch; the detector response+NMS, the FED diffusion step and the
descriptor top-2 match are hand-written CUDA C++ kernels (`ops/csrc/`),
each with a plain PyTorch twin that runs for CPU tensors.

This package never imports `jax` or `vislam_tpu`.

Subpackages
-----------
lie       quaternion, SO(3) and SE(3) math
calib     pinhole camera model (host calibration record + device ops)
data      synthetic visual-inertial sequences (numpy)
inertial  Madgwick filter, IMU preintegration, the linear VI alignment
frontend  pyramid, detection, description, matching, two-view pose
backend   triangulation, window bundle adjustment (vision-only, visual-inertial)
engine    engine state, the per-frame step, the GT-free bootstrap, the
          window refine, the sequence loop
ops       the CUDA kernels, their nvcc build and their plain twins
eval      ATE / RPE
utils     configuration, state conversion to/from numpy
"""

import torch

# The reference computes all geometry in full float32. A float32 matmul on
# the card is already full precision by default, but cuDNN runs float32
# convolutions in TF32 (~3 significant digits) unless told otherwise; pin
# both so no path of the port silently loses precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
