"""The port's Hamming+penalty stage against the JAX package.

The plain version is held against the Pallas kernel (interpret mode on the
CPU) and against hamming_matrix_f32 plus penalties: +-1 products and
their sums are exact in f32, and the penalties are added in the same
order, so every comparison is exact equality. The CUDA kernel itself runs
only on a GPU (the `cuda` test below), where it must equal the plain
version bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fasttrack_tpu.ops.hamming import hamming_matrix_f32 as jax_hamming_f32
from fasttrack_tpu.ops.hamming import signed_descriptors as jax_signed
from fasttrack_tpu.ops.pallas_kernels import hamming_penalty_matrix as jax_pallas
from fasttrack_tpu_torch.ops import cuda_build
from fasttrack_tpu_torch.ops.hamming import hamming_matrix_f32, signed_descriptors
from fasttrack_tpu_torch.ops.hamming_kernel import (
    hamming_penalty_matrix,
    hamming_penalty_matrix_reference,
)


def make_inputs(rng, M, N):
    """+-1 descriptors and penalties that include 0 and the 1e9 validity
    penalty (where f32 rounding makes the addition order matter)."""
    q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
    k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
    qp = rng.choice(np.asarray([0.0, 1e9, 3.0e6, 0.5], np.float32), M).astype(np.float32)
    kp = rng.choice(np.asarray([0.0, 1e9, 2.0e9, 7.25], np.float32), N).astype(np.float32)
    return q, k, qp, kp


def torch_args(q, k, qp, kp, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in (q, k, qp, kp))


def test_reference_equals_pallas_kernel(rng):
    q, k, qp, kp = make_inputs(rng, 256, 128)
    want = np.asarray(jax_pallas(*(jnp.asarray(a) for a in (q, k, qp, kp)), interpret=True))
    got = hamming_penalty_matrix_reference(*torch_args(q, k, qp, kp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ragged_reference_equals_xla_expression(rng):
    q, k, qp, kp = make_inputs(rng, 200, 136)
    want = np.asarray(
        jax_hamming_f32(jnp.asarray(q), jnp.asarray(k))
        + jnp.asarray(qp)[:, None] + jnp.asarray(kp)[None, :]
    )
    got = hamming_penalty_matrix_reference(*torch_args(q, k, qp, kp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_plain_path(rng):
    q, k, qp, kp = make_inputs(rng, 200, 136)
    before = hamming_penalty_matrix.launches
    got = hamming_penalty_matrix(*torch_args(q, k, qp, kp))
    assert hamming_penalty_matrix.launches == before  # no kernel launched
    torch.testing.assert_close(
        got, hamming_penalty_matrix_reference(*torch_args(q, k, qp, kp)), rtol=0, atol=0
    )


@pytest.mark.parametrize(
    "bad",
    ["q_dtype", "k_width", "pen_length", "pen_dtype"],
)
def test_wrapper_rejects_malformed_inputs(rng, bad):
    q, k, qp, kp = torch_args(*make_inputs(rng, 16, 8))
    if bad == "q_dtype":
        q = q.float()
    elif bad == "k_width":
        k = k[:, :128]
    elif bad == "pen_length":
        qp = qp[:-1]
    else:
        kp = kp.double()
    with pytest.raises(ValueError):
        hamming_penalty_matrix(q, k, qp, kp)


def test_signed_descriptors_and_hamming_f32_match_jax(rng):
    bits = rng.integers(0, 2, (64, 256)).astype(np.uint8)
    s_jax = np.asarray(jax_signed(jnp.asarray(bits)))
    s_port = signed_descriptors(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(s_port, s_jax)
    want = np.asarray(jax_hamming_f32(jnp.asarray(s_jax), jnp.asarray(s_jax[::-1].copy())))
    got = hamming_matrix_f32(torch.from_numpy(s_port), torch.from_numpy(s_port[::-1].copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_nvcc_command_targets_sm90a_into_build_dir():
    source = cuda_build.CSRC_DIR / "hamming_penalty.cu"
    assert source.is_file()
    out = cuda_build.library_path(source)
    assert out.parent.name == "_build"
    assert out.parent.parent.name == "fasttrack_tpu_torch"
    cmd = cuda_build.nvcc_command("nvcc", source, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    # the library name is keyed by the source's content
    assert out.stem.startswith("hamming_penalty-")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 1024), (2048, 1024), (1200, 1000), (1, 1)])
def test_kernel_equals_plain_on_gpu(rng, cuda_device, shape):
    args = torch_args(*make_inputs(rng, *shape), device=cuda_device)
    before = hamming_penalty_matrix.launches
    got = hamming_penalty_matrix(*args)
    torch.cuda.synchronize()
    assert hamming_penalty_matrix.launches == before + 1
    assert torch.equal(got, hamming_penalty_matrix_reference(*args))
