"""Package rules of the PyTorch port.

- No module of fasttrack_tpu_torch, and neither of the GPU scripts
  chip_smoke.py and profile_torch.py, imports jax or fasttrack_tpu (the
  JAX package's __init__ imports jax and sets a global matmul precision).
- Importing the port turns TF32 off for matmul and cuDNN (geometry stays
  in full f32, the counterpart of the JAX package's precision pin).
- Nothing on the path is random: the BRIEF pattern and its rotated
  sampling offsets equal the JAX package's.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import fasttrack_tpu_torch
from fasttrack_tpu.ops import descriptor as jax_descriptor
from fasttrack_tpu.ops.pattern import PATTERN as JAX_PATTERN
from fasttrack_tpu_torch.ops import descriptor
from fasttrack_tpu_torch.ops.pattern import PATTERN

PACKAGE = Path(fasttrack_tpu_torch.__file__).parent
ROOT = PACKAGE.parent
MODULES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "profile_torch.py"]


def imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_package_has_the_slice_modules():
    names = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    for m in (
        "geometry/so3.py", "geometry/se3.py", "cameras/models.py", "ops/pattern.py",
        "ops/pyramid.py", "ops/fast.py", "ops/orientation.py", "ops/descriptor.py",
        "ops/hamming.py", "ops/hamming_kernel.py", "ops/extractor.py",
        "ops/stereo_match.py", "ops/project_match.py", "optim/robust.py",
        "optim/pose_opt.py", "frame_pipeline.py", "convert.py",
    ):
        assert m in names, m
    assert (PACKAGE / "ops" / "csrc" / "hamming_penalty.cu").is_file()


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_module_imports_neither_jax_nor_the_jax_package(path):
    assert not imported_roots(path) & {"jax", "jaxlib", "fasttrack_tpu"}


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_brief_pattern_equals_jax():
    np.testing.assert_array_equal(PATTERN, JAX_PATTERN)


def test_sampling_offsets_equal_jax_sampling_matrices():
    mats = jax_descriptor._SAMPLING  # (bins, 512, P*P) one-hot
    assert (mats.sum(-1) == 1).all()
    np.testing.assert_array_equal(descriptor._sampling_indices(), mats.argmax(-1))
    assert (descriptor.N_ANGLE_BINS, descriptor.PATCH_HALF_EXT) == (
        jax_descriptor.N_ANGLE_BINS, jax_descriptor.PATCH_HALF_EXT,
    )
