"""vislam_tpu_torch — the PyTorch/CUDA port of vislam_tpu.

The JAX package `vislam_tpu` stays the reference; this package mirrors its
layout module for module, and every public name of the reference has its
counterpart here under the same name (tests/test_torch_api.py), except
the Pallas entry points, which are the CUDA kernels' wrappers, the libpng
loader (`data/native_loader.py`; `data/png.py` and the prefetching loader
do its work) and the OpenCV baseline (`eval/opencv_ref.py`).

It runs the per-frame VIO step on an NVIDIA Hopper card (GT scale, or
GT-free with the VI alignment, open loop or with the in-step window VI-BA
of SLAM mode; IMU or vision-only rotation), one sequence or a batch under
torch.func.vmap, behind the reference's CLI, with every frontend of the
reference: the Gaussian or nonlinear (KAZE/AKAZE) scale space, the five
detector families, SIFT or BRIEF descriptors, upright or oriented. Plain
tensor code is PyTorch; the detector response + NMS, the FED diffusion
step, the descriptor top-2 match and the RANSAC's categorical draws are
hand-written CUDA C++ kernels (`ops/csrc/`), each with a plain PyTorch
twin that runs for CPU tensors. Entry points and tensor creators run on
the card unless the caller passes `device="cpu"`.

This package never imports `jax` or `vislam_tpu`.

Subpackages
-----------
lie       quaternion, SO(3), SE(3), Sim(3) and roll-pitch-yaw math
calib     camera model, undistortion, calibration presets and XML
data      EuRoC, KITTI and TUM readers, the PNG codec, the prefetching
          loader, synthetic and adversarial sequences
inertial  Madgwick and complementary filters, IMU preintegration and
          dead-reckoning, bias calibration, the linear VI alignment
frontend  pyramid and nonlinear scale space, detection, description,
          matching, two-view pose (translation and essential RANSAC)
backend   triangulation, the window (VI-)BA, photometric alignment, and
          the map backend: pose graphs (SE(3), Sim(3)), loops, PnP,
          relocalization, keyframe maps
engine    engine state, the per-frame step, the GT-free bootstrap, the
          window refine, the sequence loop and batched sequences
ops       the CUDA kernels, their nvcc build and their plain twins
parallel  process groups, the landmark-sharded (VI-)BA, sharded batches
eval      ATE / RPE, trajectory files, the VIO runner, matchability
viz       trajectory and state plots, live snapshots (matplotlib)
utils     configuration, stage timing, checkpoints, state conversion,
          the random stream (JAX's threefry), debugging switches
"""

import torch

# The reference computes all geometry in full float32. A float32 matmul on
# the card is already full precision by default, but cuDNN runs float32
# convolutions in TF32 (~3 significant digits) unless told otherwise; pin
# both so no path of the port silently loses precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
