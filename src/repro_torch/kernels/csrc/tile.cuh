// The shared-memory tile loop of gemm_nt.cu, syrk_ln.cu and trsm_rlt.cu,
// and the CHECK macro of their launch functions.
//
// One block of NT = 256 threads computes a TILE x TILE (64 x 64) fp64
// product tile, each thread holding a 4 x 4 accumulator; the two operands'
// row panels stream through shared memory in K-chunks of TK = 8, stored
// transposed with a padded stride (TILE + 1) so the inner loop reads without
// bank conflicts.  Rows past the operands' extents and columns past K read
// as zero, so every edge is masked and nothing is padded.  A faster tile
// (mma.sync f64 DMMA, TMA staging) replaces this one loop for all three.
#pragma once
#include <cuda_runtime.h>

#define CHECK(x)                                  \
  do {                                            \
    cudaError_t err_ = (x);                       \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

namespace {

constexpr int TILE = 64;  // output tile edge
constexpr int TK = 8;     // depth of one shared-memory K chunk
constexpr int NT = 256;   // threads per block
constexpr int LDT = TILE + 1;

// acc[i][j] += sum_k A[r][k] * B[c][k] for r = ty + 16 i, c = tx + 16 j,
// k in [0, K), with tx = threadIdx.x % 16 and ty = threadIdx.x / 16.  Rows
// past arows / brows read as zero.  As and Bs hold TK * LDT doubles each.
// No __restrict__: in trsm_rlt.cu, A is the X the kernel writes.  Every
// thread of the block must call it (it holds block barriers).
__device__ __forceinline__ void gemm_nt_tile(const double* A, int lda,
                                             int arows, const double* B,
                                             int ldb, int brows, int K,
                                             double (&acc)[4][4], double* As,
                                             double* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TILE * TK; e += NT) {
      const int r = e / TK, k = e % TK;
      const bool kin = k0 + k < K;
      As[k * LDT + r] = (r < arows && kin) ? A[(size_t)r * lda + k0 + k] : 0.0;
      Bs[k * LDT + r] = (r < brows && kin) ? B[(size_t)r * ldb + k0 + k] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k * LDT + ty + 16 * i];
        b[i] = Bs[k * LDT + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace
