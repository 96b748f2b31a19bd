// Lower SYRK for Hopper, fp64: C = tril(A A^T) for A (M, K), C (M, M), the
// strict upper triangle of C written as zero; rows contiguous, with leading
// dimensions lda, ldc.
//
// Replaces the TPU kernel src/repro/kernels/syrk.py::syrk_ln
// (_syrk_kernel): the GEMM tiling with tiles above the diagonal skipped by
// pl.when and diagonal tiles masked by row >= col.  On the sequential path
// it computes RL's update matrix U = tril(T T^T) of an unfused factor
// (engines._syrk_tail_fn), RLB's diagonal block updates
// (engines._syrk_block_fn), and, inside the blocked potrf routine, the
// trailing update of each 128-column step.
//
// Design: one block of 256 threads per 64 x 64 tile of C over the full
// (row tile, column tile) grid.  A tile wholly above the diagonal writes its
// zeros and exits, so it costs one pass of stores and no flops -- the
// saving DSYRK has over DGEMM.  Lower tiles stream their two row panels of A
// through shared memory in K-chunks of 8 with a 4 x 4 accumulator per
// thread (the tile loop of tile.cuh); diagonal tiles mask row >= col.
// Edges are masked, so M and K take any value and nothing is padded.
//
// Bound on this card: M^2 K flops (the lower half of 2 M^2 K) against
// 8 (M K + M^2) bytes: flop-bound at the fp64 tensor-core peak (67 TFLOP/s
// SXM) once K is past about 40, byte-bound at 3.35 TB/s for thin A.  This
// first version does scalar fp64 FMAs; DMMA tiles are left for later.
#include "tile.cuh"

namespace {

__global__ void syrk_ln_kernel(const double* __restrict__ A, int lda,
                               double* __restrict__ C, int ldc, int M, int K) {
  const int rt = blockIdx.y, ct = blockIdx.x;
  const int r0 = rt * TILE, c0 = ct * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __shared__ double As[TK * LDT], Bs[TK * LDT];
  double acc[4][4] = {};
  if (ct <= rt) {  // uniform over the block: the barriers inside are safe
    gemm_nt_tile(A + (size_t)r0 * lda, lda, min(TILE, M - r0),
                 A + (size_t)c0 * lda, lda, min(TILE, M - c0), K, acc, As,
                 Bs);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r < M && c < M) C[(size_t)r * ldc + c] = r >= c ? acc[i][j] : 0.0;
    }
}

}  // namespace

// A (M, K), C (M, M) fp64, rows contiguous; M >= 1.  Returns a cudaError_t
// code.
extern "C" int syrk_ln_launch(const double* A, int lda, double* C, int ldc,
                              int M, int K, int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  const int nt = (M + TILE - 1) / TILE;
  syrk_ln_kernel<<<dim3(nt, nt), NT, 0, stream>>>(A, lda, C, ldc, M, K);
  CHECK(cudaGetLastError());
  return 0;
}

extern "C" const char* syrk_ln_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
