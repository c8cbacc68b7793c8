"""fasttrack_tpu_torch — the fasttrack_tpu tracking front end in PyTorch.

A port of the JAX package `fasttrack_tpu` to PyTorch and CUDA on an NVIDIA
Hopper GPU. Module paths mirror `fasttrack_tpu/` file for file; public
functions keep the JAX package's signatures and array layouts (x/y as
separate (N,) tensors, signed descriptors as (N, 256) int8 +-1, packed
descriptors as (N, 32) uint8), so each module can be held against its JAX
counterpart by a parity test. This package imports neither jax nor
fasttrack_tpu.

Where the JAX package ran a Pallas kernel, the port runs a kernel written
by hand for Hopper (`ops/hamming_kernel.py`, CUDA C++ under `ops/csrc/`);
everything else is plain PyTorch on the tensors' device.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry stays in full f32: TF32 keeps ~10 mantissa bits, which rounds
# point coordinates at ~1e-3 relative and rides through projection into
# every match window and pose solve (the counterpart of the JAX package's
# global "highest" matmul precision pin). cuDNN convolutions default to
# TF32 as well, so both switches are set.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
