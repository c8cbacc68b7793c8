"""The port's fused Hamming+penalty+top-K against the JAX package.

What the kernel replaces is `lax.top_k(-hamming_penalty_matrix(...), 64)`.
The plain version is held against exactly that, with the Pallas kernel in
interpret mode on the CPU (tile-aligned shapes) or the XLA expression
(ragged shapes, N < K). Distances are exact integers in f32 and the
penalties are added in the same order, so values AND indices must be
equal: ties go to the lower column on both sides. The CUDA kernel itself
runs only on a GPU (the `cuda` test below), where it must equal the plain
version bit for bit.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fasttrack_tpu.ops.hamming import hamming_matrix_f32 as jax_hamming_f32
from fasttrack_tpu.ops.pallas_kernels import hamming_penalty_matrix as jax_pallas
from fasttrack_tpu_torch.ops import cuda_build
from fasttrack_tpu_torch.ops.hamming_kernel import (
    MAX_K,
    MAX_N,
    hamming_penalty_topk,
    hamming_penalty_topk_reference,
)

TOP_K = 64
BIG = np.float32(1e9)


def descriptors(rng, n, distinct=None):
    """(n, 256) +-1 int8; with `distinct`, rows drawn from that few
    descriptors, so that most distances tie."""
    if distinct is None:
        return (2 * rng.integers(0, 2, (n, 256)) - 1).astype(np.int8)
    base = (2 * rng.integers(0, 2, (distinct, 256)) - 1).astype(np.int8)
    return base[rng.integers(0, distinct, n)]


def make_case(rng, name):
    """(q, k, q_pen, k_pen) of one named case."""
    zeros = lambda n: np.zeros(n, np.float32)
    if name == "128x128":
        return descriptors(rng, 128), descriptors(rng, 128), zeros(128), zeros(128)
    if name == "256x384":
        return descriptors(rng, 256), descriptors(rng, 384), zeros(256), zeros(384)
    if name == "ties":
        return descriptors(rng, 128, 3), descriptors(rng, 256, 3), zeros(128), zeros(256)
    if name == "penalties":  # 1e9 rounds the sum: the add order is part of the result
        pens = np.asarray([0.0, 0.5, 1e9, 2e9], np.float32)
        return (descriptors(rng, 128, 5), descriptors(rng, 256, 5),
                rng.choice(pens, 128).astype(np.float32), rng.choice(pens, 256).astype(np.float32))
    if name == "taken":      # the matchers' penalties: validity, and validity + taken
        q_valid, k_valid = rng.random(256) > 0.1, rng.random(128) > 0.1
        taken = rng.random(128) < 0.3
        return (descriptors(rng, 256), descriptors(rng, 128),
                ((1 - q_valid) * BIG).astype(np.float32),
                ((1 - k_valid) * BIG + taken * BIG).astype(np.float32))
    raise ValueError(name)


def torch_args(q, k, qp, kp, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (q, k, qp, kp))


def assert_equals_lax_top_k(dm_jax, args, k=TOP_K):
    neg, idx = jax.lax.top_k(-dm_jax, min(k, dm_jax.shape[1]))
    values, indices = hamming_penalty_topk_reference(*torch_args(*args), k)
    assert indices.dtype == torch.int64 and values.dtype == torch.float32
    np.testing.assert_array_equal(values.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(idx))


@pytest.mark.parametrize("case", ["128x128", "256x384", "ties", "penalties", "taken"])
def test_reference_equals_top_k_of_pallas_kernel(rng, case):
    args = make_case(rng, case)
    q, k, qp, kp = (jnp.asarray(a) for a in args)
    assert_equals_lax_top_k(jax_pallas(q, k, qp, kp, interpret=True), args)


@pytest.mark.parametrize("shape", [(200, 136), (50, 40)], ids=["ragged", "n_below_k"])
def test_reference_equals_top_k_of_xla_expression(rng, shape):
    M, N = shape
    pens = np.asarray([0.0, 1e9, 3.0e6, 0.5], np.float32)
    args = (descriptors(rng, M, 7), descriptors(rng, N, 7),
            rng.choice(pens, M).astype(np.float32), rng.choice(pens, N).astype(np.float32))
    q, k, qp, kp = (jnp.asarray(a) for a in args)
    assert_equals_lax_top_k(jax_hamming_f32(q, k) + qp[:, None] + kp[None, :], args)
    values, indices = hamming_penalty_topk_reference(*torch_args(*args), TOP_K)
    assert values.shape == indices.shape == (M, min(TOP_K, N))


def test_values_ascend_and_ties_take_the_lower_column(rng):
    args = torch_args(*make_case(rng, "ties"))
    values, indices = hamming_penalty_topk_reference(*args, TOP_K)
    v, i = values.numpy(), indices.numpy()
    assert (np.diff(v, axis=1) >= 0).all()
    tied = np.diff(v, axis=1) == 0
    assert tied.mean() > 0.5                      # the case does tie
    assert (np.diff(i, axis=1)[tied] > 0).all()


def test_cpu_tensor_takes_plain_path(rng):
    args = torch_args(*make_case(rng, "penalties"))
    before = hamming_penalty_topk.launches
    values, indices = hamming_penalty_topk(*args, TOP_K)
    assert hamming_penalty_topk.launches == before  # no kernel launched
    want_v, want_i = hamming_penalty_topk_reference(*args, TOP_K)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)


@pytest.mark.parametrize("bad", ["q_dtype", "k_width", "pen_length", "pen_dtype", "k_zero"])
def test_wrapper_rejects_malformed_inputs(rng, bad):
    q, k, qp, kp = torch_args(*make_case(rng, "128x128"))
    top = TOP_K
    if bad == "q_dtype":
        q = q.float()
    elif bad == "k_width":
        k = k[:, :128]
    elif bad == "pen_length":
        qp = qp[:-1]
    elif bad == "pen_dtype":
        kp = kp.double()
    else:
        top = 0
    with pytest.raises(ValueError):
        hamming_penalty_topk(q, k, qp, kp, top)


def test_kernel_limits_and_source():
    assert (MAX_K, MAX_N) == (64, 4096)  # the tracker's K, and 4x its widest key side
    source = cuda_build.CSRC_DIR / "hamming_topk.cu"
    assert source.is_file()
    assert cuda_build.library_path(source).stem.startswith("hamming_topk-")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(1024, 1024), (2048, 1024), (4096, 1024), (1200, 1000), (33, 40), (64, 4096)]
)
def test_kernel_equals_plain_on_gpu(rng, cuda_device, shape):
    M, N = shape
    pens = np.asarray([0.0, 0.5, 1e9, 2e9], np.float32)
    args = torch_args(descriptors(rng, M, 9), descriptors(rng, N, 9),
                      rng.choice(pens, M).astype(np.float32),
                      rng.choice(pens, N).astype(np.float32), device=cuda_device)
    before = hamming_penalty_topk.launches
    values, indices = hamming_penalty_topk(*args, TOP_K)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches == before + 1
    want_v, want_i = hamming_penalty_topk_reference(*args, TOP_K)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 1024), (1000, 900)])
def test_match_fisheye_launches_the_kernel_with_k_2_on_gpu(rng, cuda_device, shape):
    """K = 2 with validity penalties, as match_fisheye calls the kernel: rows
    whose query is invalid tie at 1e9 across all columns."""
    from fasttrack_tpu_torch.ops.stereo_match import match_fisheye

    M, N = shape
    l_desc, r_desc = descriptors(rng, M, 9), descriptors(rng, N, 9)
    l_valid, r_valid = rng.random(M) > 0.2, rng.random(N) > 0.2
    on = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
          for a in (l_desc, l_valid, r_desc, r_valid)]
    before = hamming_penalty_topk.launches_by_k[2]
    got = match_fisheye(*on)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches_by_k[2] == before + 1
    want = match_fisheye(*(t.cpu() for t in on))      # the plain version, on the CPU
    assert torch.equal(got.idx_right.cpu(), want.idx_right)
    assert torch.equal(got.valid.cpu(), want.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 4096), (700, 64)])
def test_vocabulary_assign_launches_the_kernel_with_k_1_on_gpu(rng, cuda_device, shape):
    """K = 1 with zero penalties, as the flat vocabulary's `_assign` calls the
    kernel (4096 words at most, MAX_N): the word of every descriptor equals
    the plain argmin's first index, and so does the distance, with rows
    drawn from few descriptors so that most of them tie."""
    from fasttrack_tpu_torch.bow.vocabulary import _assign, _assign_reference

    M, N = shape
    descs = torch.from_numpy(descriptors(rng, M, 7)).to(cuda_device)
    words = torch.from_numpy(descriptors(rng, N, 5)).to(cuda_device)
    before = hamming_penalty_topk.launches_by_k[1]
    got = _assign(descs, words)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches_by_k[1] == before + 1
    assert torch.equal(got.cpu(), _assign_reference(descs.cpu(), words.cpu()))
    zeros_q, zeros_k = torch.zeros(M, device=cuda_device), torch.zeros(N, device=cuda_device)
    values, indices = hamming_penalty_topk(descs, words, zeros_q, zeros_k, 1)
    want_v, want_i = hamming_penalty_topk_reference(descs, words, zeros_q, zeros_k, 1)
    assert torch.equal(values, want_v) and torch.equal(indices, want_i)


@pytest.mark.cuda
def test_vocabulary_assign_chunks_a_wide_vocabulary_on_gpu(rng, cuda_device):
    """5,000 words, wider than the kernel's MAX_N: one K = 1 launch per chunk
    of at most 4,096 words, merged on the card; the words equal the plain
    argmin's first index, with rows tied inside and across the chunks and
    exact words only in the second chunk."""
    from fasttrack_tpu_torch.bow.vocabulary import _assign, _assign_reference
    from fasttrack_tpu_torch.ops.hamming_kernel import MAX_N

    M, N = 1024, 5000
    descs = descriptors(rng, M, 7)
    words = descriptors(rng, N, 5)
    words[MAX_N:MAX_N + 8] = descs[:8]
    words[4800:4808] = descs[:8]
    descs_t, words_t = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                        for a in (descs, words))
    before = hamming_penalty_topk.launches_by_k[1]
    got = _assign(descs_t, words_t)
    torch.cuda.synchronize()
    assert hamming_penalty_topk.launches_by_k[1] == before + 2
    want = _assign_reference(descs_t.cpu(), words_t.cpu())
    assert torch.equal(got.cpu(), want) and (want >= MAX_N).any()
