// Hamming distance plus rank-1 penalties for signed (+-1 int8) descriptors.
//
// Replaces fasttrack_tpu/ops/pallas_kernels.py:hamming_penalty_matrix, the
// JAX package's Pallas TPU kernel, and computes what it computes:
//
//     out[i, j] = (256 - <q_i, k_j>) * 0.5 + q_pen[i] + k_pen[j]
//
// for q (M, 256) and k (N, 256) int8 in {-1, +1}, q_pen (M,) and k_pen (N,)
// float32, out (M, N) float32 row-major. The first term is the Hamming
// distance of the two descriptors. Both matchers of the tracking path get
// their penalised distance matrix from it (search-by-projection 2048 x 1024,
// rectified stereo 1024 x 1024).
//
// What bounds it on an H100: the float32 output write. At 2048 x 1024 it
// writes 8 MiB, against 768 KiB of int8 operands (96 KiB once packed to
// bits), and the arithmetic is 8 XOR + POPC per output: memory, not
// arithmetic. So the design keeps arithmetic trivial and the stores
// coalesced:
//   - each block packs its 32 query rows and 128 key rows to 8 x uint32 of
//     sign bits in shared memory, in the spirit of FastTrack's
//     DescriptorDistance (CudaUtils.cu:42-56): Hamming = sum of
//     __popc(a ^ b) over the 8 words, which equals (256 - dot) / 2 exactly
//     for +-1 entries (an entry's sign bit is its bit);
//   - each thread keeps 4 key columns in registers and walks 4 query rows;
//     a warp stores 32 consecutive floats of one output row (128 bytes);
//   - penalties are added in f32 in the Pallas and XLA order, q_pen first,
//     then k_pen: with 1e9 penalties the sum rounds, so the order is part
//     of the result;
//   - the ragged edge is masked here, so M and N need not be multiples of
//     the block (the Pallas kernel required multiples of 128).
// Fusing the per-row top-k that consumes the matrix, so that it never
// reaches device memory, is later work.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;  // 256 bits as 8 x uint32
constexpr int kThreadsX = 32;  // along N, the contiguous output axis
constexpr int kThreadsY = 8;   // along M
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 4;
constexpr int kBlockM = kThreadsY * kRowsPerThread;  // 32 query rows
constexpr int kBlockN = kThreadsX * kColsPerThread;  // 128 key rows
constexpr int kRowBytes16 = 256 / 16;                // a row is 16 x uint4

// Bit 7 of each byte is the sign of one int8 lane: -1 -> 1, +1 -> 0.
__device__ __forceinline__ uint32_t sign_nibble(uint32_t x) {
  return ((x >> 7) & 1u) | ((x >> 14) & 2u) | ((x >> 21) & 4u) | ((x >> 28) & 8u);
}

// Packs rows [row0, row0 + kCount) of an (n, 256) int8 matrix into
// bits[w][r], word-major so that a warp reading consecutive rows of one
// word touches consecutive banks. Rows past n pack to 0.
template <int kCount>
__device__ __forceinline__ void pack_rows(const uint4* __restrict__ src, int n,
                                          int row0, uint32_t (*bits)[kCount]) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int item = tid; item < kCount * kWords; item += kThreadsX * kThreadsY) {
    const int w = item / kCount;
    const int r = item % kCount;
    uint32_t word = 0;
    if (row0 + r < n) {
      // word w holds bytes [32w, 32w + 32) of the row: two 16-byte loads
      const uint4* p = src + static_cast<size_t>(row0 + r) * kRowBytes16 + 2 * w;
      const uint4 a = p[0];
      const uint4 b = p[1];
      const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) word |= sign_nibble(v[i]) << (4 * i);
    }
    bits[w][r] = word;
  }
}

__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    hamming_penalty_kernel(const uint4* __restrict__ q, const uint4* __restrict__ k,
                           const float* __restrict__ q_pen,
                           const float* __restrict__ k_pen, float* __restrict__ out,
                           int M, int N) {
  __shared__ uint32_t q_bits[kWords][kBlockM];
  __shared__ uint32_t k_bits[kWords][kBlockN];
  const int m0 = blockIdx.y * kBlockM;
  const int n0 = blockIdx.x * kBlockN;
  pack_rows<kBlockM>(q, M, m0, q_bits);
  pack_rows<kBlockN>(k, N, n0, k_bits);
  __syncthreads();

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  uint32_t kw[kColsPerThread][kWords];
  float kp[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int col = tx + c * kThreadsX;
#pragma unroll
    for (int w = 0; w < kWords; ++w) kw[c][w] = k_bits[w][col];
    kp[c] = (n0 + col < N) ? k_pen[n0 + col] : 0.0f;
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = ty + r * kThreadsY;
    const int i = m0 + row;
    if (i >= M) break;
    uint32_t qw[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) qw[w] = q_bits[w][row];
    const float qp = q_pen[i];
    float* out_row = out + static_cast<size_t>(i) * N;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = n0 + tx + c * kThreadsX;
      if (j < N) {
        int h = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) h += __popc(qw[w] ^ kw[c][w]);
        out_row[j] = __fadd_rn(__fadd_rn(static_cast<float>(h), qp), kp[c]);
      }
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// q and k must be 16-byte aligned and contiguous; M, N > 0 and
// ceil(M / 32) <= 65535 (the wrapper checks all of this).
extern "C" int hamming_penalty_launch(const void* q, const void* k, const void* q_pen,
                                      const void* k_pen, void* out, int M, int N,
                                      void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
  hamming_penalty_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k),
      static_cast<const float*>(q_pen), static_cast<const float*>(k_pen),
      static_cast<float*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hamming_penalty_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
