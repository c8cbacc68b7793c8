// Hamming distance plus rank-1 penalties for signed (+-1 int8) descriptors.
//
// Replaces fasttrack_tpu/ops/pallas_kernels.py:hamming_penalty_matrix, the
// JAX package's Pallas TPU kernel, and computes what it computes:
//
//     out[i, j] = (256 - <q_i, k_j>) * 0.5 + q_pen[i] + k_pen[j]
//
// for q (M, 256) and k (N, 256) int8, q_pen (M,) and k_pen (N,) float32,
// out (M, N) float32 row-major. For +-1 entries the first term is the
// Hamming distance of the two descriptors. The tracker's matchers reduce
// this matrix to its K best columns per row and call the fused kernel in
// hamming_topk.cu instead; this one serves the callers that want the
// matrix itself.
//
// What bounds it on an H100: by the roofline, the float32 output write
// (8 MiB at 2048 x 1024 against 768 KiB of int8 operands). Measured, it is
// the rate at which mma.sync runs int8 products: every tiling, store
// pattern and operand-reuse scheme tried runs at the same ~0.7 us per MiB
// of output (a plain fill of the output takes 0.3), and an f16 variant with
// twice the mma count is 1.6x slower. Only the warpgroup instruction
// (wgmma) reaches the tensor cores' full rate on this card; that is later
// work. The first version of this kernel packed sign bits and counted them
// with POPC, a quarter-rate instruction of which it needed 8 per output,
// and every block packed its operands again; it took 1.7x as long. This
// one does what the Pallas kernel did on the MXU, on the tensor cores:
//   - the dot product is an int8 mma.sync (m16n8k32, s32 accumulate, exact),
//     eight per 16 x 8 output tile; nothing is packed and no operand byte
//     is converted;
//   - fragments come straight from global memory as 16-byte loads. A dot
//     product does not care in which order the 256 positions are summed,
//     so a thread loads 16 contiguous bytes of a row and feeds them to two
//     mma steps as they lie: the same permutation of positions on both
//     operands. Operands total under 1 MiB and stay in L1/L2;
//   - a warp owns 16 rows x 64 columns, keeps its 16 query rows in
//     registers for all 8 column tiles, and a block of 8 warps covers
//     32 x 256, so 2048 x 1024 is 256 blocks of even work;
//   - key fragments are loaded one step ahead of the mma that reads them,
//     and the dot products leave through a shared-memory tile of the warp,
//     so that a store instruction writes two runs of 256 contiguous bytes
//     (float4 per thread); rows whose length is not a multiple of 4 floats
//     take scalar stores;
//   - penalties are added in f32 in the Pallas and XLA order, q_pen first,
//     then k_pen: with 1e9 penalties the sum rounds, so the order is part
//     of the result;
//   - ragged edges are masked here (loads clamp to the last row, stores
//     are guarded), so M and N need not be multiples of any tile.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowVec = 256 / 16;  // a descriptor row is 16 x uint4
constexpr int kWarpsM = 2;         // warps of a block along M
constexpr int kWarpsN = 4;         // and along N
constexpr int kWarpM = 16;         // rows of a warp tile: one mma m-tile
constexpr int kWarpN = 64;         // columns of a warp tile: 8 mma n-tiles
constexpr int kBlockM = kWarpsM * kWarpM;  // 32
constexpr int kBlockN = kWarpsN * kWarpN;  // 256
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
// Row stride of a warp's tile in ints: 8 more than its width, so that the
// fragments' 8-byte writes and the rows' 16-byte reads both spread over all banks.
constexpr int kTileStride = kWarpN + 8;

// D (16x8, s32) += A (16x32, s8, row) * B (32x8, s8, col).
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float finish(int dot, float qp, float kp) {
  return __fadd_rn(__fadd_rn(static_cast<float>(256 - dot) * 0.5f, qp), kp);
}

// The key fragments of two 16 x 8 tiles at columns nb + g and nb + 8 + g:
// 4 x 16 bytes of each key row, the same bytes as the query side takes.
__device__ __forceinline__ void load_keys(uint4 (&dst)[8], const uint4* __restrict__ k, int nb,
                                          int g, int t, int N) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4* kb = k + static_cast<size_t>(min(nb + 8 * j + g, N - 1)) * kRowVec + t;
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[4 * j + c] = __ldg(kb + 4 * c);
  }
}

__global__ void __launch_bounds__(kThreads)
    hamming_penalty_kernel(const uint4* __restrict__ q, const uint4* __restrict__ k,
                           const float* __restrict__ q_pen,
                           const float* __restrict__ k_pen, float* __restrict__ out,
                           int M, int N) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the mma "group": a row of A and C, a column of B
  const int t = lane & 3;   // the thread in its group: which 16 bytes of 64
  const int m0 = blockIdx.y * kBlockM + (warp / kWarpsN) * kWarpM;
  const int n0 = blockIdx.x * kBlockN + (warp % kWarpsN) * kWarpN;
  if (m0 >= M || n0 >= N) return;  // the whole warp leaves: no barrier follows

  // The warp's 16 query rows, 8 x 16 bytes per thread: rows g and g + 8.
  const int r0 = m0 + g;
  const int r1 = r0 + 8;
  const uint4* qa = q + static_cast<size_t>(min(r0, M - 1)) * kRowVec + t;
  const uint4* qb = q + static_cast<size_t>(min(r1, M - 1)) * kRowVec + t;
  uint4 a_lo[4], a_hi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a_lo[c] = __ldg(qa + 4 * c);
    a_hi[c] = __ldg(qb + 4 * c);
  }
  // The warp's 16 x 64 dot products go through its own shared-memory tile,
  // so that they leave as whole rows: a store instruction then writes two
  // runs of 256 contiguous bytes instead of eight of 32.
  __shared__ __align__(16) int tiles[kWarpsM * kWarpsN][kWarpM][kTileStride];
  int (*tile)[kTileStride] = tiles[warp];

  // Key fragments are loaded one step ahead of the mma that reads them, so
  // that a step's loads fly while the step before computes.
  uint4 b[2][8];
  load_keys(b[0], k, n0, g, t, N);
#pragma unroll
  for (int step = 0; step < kWarpN / 16; ++step) {
    const int nb = n0 + 16 * step;
    if (nb >= N) break;  // the same for the whole warp
    if (step + 1 < kWarpN / 16 && nb + 16 < N) load_keys(b[(step + 1) & 1], k, nb + 16, g, t, N);
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // two 16 x 8 tiles: columns nb + g and nb + 8 + g
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 kb = b[step & 1][4 * j + c];
        mma_s8(acc, a_lo[c].x, a_hi[c].x, a_lo[c].y, a_hi[c].y, kb.x, kb.y);
        mma_s8(acc, a_lo[c].z, a_hi[c].z, a_lo[c].w, a_hi[c].w, kb.z, kb.w);
      }
      // a thread holds columns 2t, 2t + 1 of rows g and g + 8
      const int col = 16 * step + 8 * j + 2 * t;
      *reinterpret_cast<int2*>(&tile[g][col]) = make_int2(acc[0], acc[1]);
      *reinterpret_cast<int2*>(&tile[g + 8][col]) = make_int2(acc[2], acc[3]);
    }
  }
  __syncwarp();

  // Out: lane l takes columns 4 * (l % 16) .. + 3 of rows l / 16, l / 16 + 2, ...
  const int c4 = 4 * (lane & 15);
  const int col = n0 + c4;
  if (col >= N) return;
  const bool vec = (N & 3) == 0;  // every output row starts 16-byte aligned
  float kp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kp[i] = col + i < N ? k_pen[col + i] : 0.0f;
#pragma unroll
  for (int r = lane >> 4; r < kWarpM; r += 2) {
    const int row = m0 + r;
    if (row >= M) break;
    const float qp = q_pen[row];
    const int4 d = *reinterpret_cast<const int4*>(&tile[r][c4]);
    float* dst = out + static_cast<size_t>(row) * N + col;
    if (vec) {  // N % 4 == 0 and col % 4 == 0: all four are inside
      *reinterpret_cast<float4*>(dst) = make_float4(
          finish(d.x, qp, kp[0]), finish(d.y, qp, kp[1]), finish(d.z, qp, kp[2]),
          finish(d.w, qp, kp[3]));
    } else {
      const int dots[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (col + i < N) dst[i] = finish(dots[i], qp, kp[i]);
      }
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// q, k and out must be 16-byte aligned and contiguous; M, N > 0 and
// ceil(M / 32) <= 65535 (the wrapper checks all of this).
extern "C" int hamming_penalty_launch(const void* q, const void* k, const void* q_pen,
                                      const void* k_pen, void* out, int M, int N,
                                      void* stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
  hamming_penalty_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k),
      static_cast<const float*>(q_pen), static_cast<const float*>(k_pen),
      static_cast<float*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hamming_penalty_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
