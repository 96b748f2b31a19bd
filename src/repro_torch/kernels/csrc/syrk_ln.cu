// Lower SYRK for Hopper, fp64, in two forms over one kernel:
//   syrk_ln_launch      C = tril(A A^T) for A (M, K), C (M, M), the strict
//                       upper triangle of C written as zero;
//   syrk_ln_sub_launch  C -= A A^T on and below the diagonal only, in place
//                       (the cells above the diagonal are never touched).
// Rows contiguous, leading dimensions lda, ldc; in the subtract form A must
// share no cell with C.
//
// Replaces the TPU kernel src/repro/kernels/syrk.py::syrk_ln
// (_syrk_kernel): the GEMM tiling with tiles above the diagonal skipped by
// pl.when and diagonal tiles masked by row >= col.  On the sequential path
// the plain form computes RL's update matrix U = tril(T T^T) of an unfused
// factor (engines._syrk_tail_fn) and RLB's diagonal block updates
// (engines._syrk_block_fn); the subtract form is the trailing update of
// each 128-column step of the blocked potrf routine, which the reference
// writes as trail - syrk_ln(X): here it needs no M x M temporary and no
// elementwise pass.
//
// Design: one block of 256 threads (8 warps) per 64 x 64 tile on or below
// the diagonal, on the DMMA tile of tile.cuh (dmma_tile_nt:
// mma.sync.aligned.m16n8k8 f64, K in chunks of 32 staged by cp.async three
// deep in shared memory, 16-byte copies where the operand's address and ld
// allow, 8-byte ones otherwise), both operands being row panels of A.  The
// grid is triangular: nt (nt + 1) / 2 blocks on gridDim.x for nt = ceil(M /
// 64) tile rows, block t taking the tile (rt, ct) with t = rt (rt + 1) / 2
// + ct, so no block exists only to skip its work.  Diagonal tiles mask
// r >= c.  In the plain form the output comes from torch.empty, so each
// tile below the diagonal also zeroes its mirror tile (ct, rt) above it
// (issued before its product, so the stores drain under it) and each
// diagonal tile writes zeros above its diagonal: every cell is written
// once.  Edges are masked, so M and K take any value and nothing is
// padded.
//
// Bound on this card: M^2 K flops (the lower half of 2 M^2 K, counted at
// M (M + 1) K / 2 multiply-adds) against 8 (M K + M^2) bytes (the subtract
// form reads and writes M (M + 1) / 2 cells of C instead): flop-bound at
// the fp64 tensor-core peak (67 TFLOP/s SXM) once K is past about 40,
// byte-bound at 3.35 TB/s for thin A.  The diagonal tiles do a full tile's
// product for half a tile of output, and at M = 1200 the 190 tiles are
// about 0.7 of a wave of two blocks per SM, so the card is not full; small
// calls (RLB's 64-row blocks) are one tile on one SM, bound by the launch.
#include "tile.cuh"

namespace {

// The tile (rt, ct), 0 <= ct <= rt, of linear block t = rt (rt + 1) / 2 +
// ct: rt from the square root, corrected for its rounding.
__device__ __forceinline__ void tri_tile(int t, int& rt, int& ct) {
  int r = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((long long)r * (r + 1) / 2 > t) --r;
  while ((long long)(r + 1) * (r + 2) / 2 <= t) ++r;
  rt = r;
  ct = t - (int)((long long)r * (r + 1) / 2);
}

template <bool SUB>
__global__ void __launch_bounds__(DNT)
    syrk_ln_kernel(const double* A, int lda, double* C, int ldc, int M,
                   int K) {
  int rt, ct;
  tri_tile(blockIdx.x, rt, ct);
  const int r0 = rt * DT, c0 = ct * DT;
  if (!SUB && ct < rt) {  // the mirror tile (ct, rt), above the diagonal
    const int nrow = min(DT, M - c0), ncol = min(DT, M - r0);
    for (int e = threadIdx.x; e < DT * DT; e += DNT) {
      const int i = e / DT, j = e % DT;
      if (i < nrow && j < ncol) C[(size_t)(c0 + i) * ldc + r0 + j] = 0.0;
    }
  }
  extern __shared__ __align__(16) double sm[];
  double acc[2][16 / DNW][4] = {};
  dmma_tile_nt(A + (size_t)r0 * lda, lda, min(DT, M - r0),
               A + (size_t)c0 * lda, lda, min(DT, M - c0), K, acc, sm);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16 / DNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + dmma_row<DNW>(i, e), c = c0 + dmma_col<DNW>(j, e);
        if (r >= M || c >= M) continue;
        double* out = C + (size_t)r * ldc + c;
        if (SUB) {
          if (r >= c) *out -= acc[i][j][e];
        } else {
          *out = r >= c ? acc[i][j][e] : 0.0;
        }
      }
}

template <bool SUB>
int launch(const double* A, int lda, double* C, int ldc, int M, int K,
           int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  const long long nt = (M + DT - 1) / DT, blocks = nt * (nt + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  static bool allowed[64];  // the dynamic shared memory, once per device
  if (!(device >= 0 && device < 64 && allowed[device])) {
    CHECK(cudaFuncSetAttribute(syrk_ln_kernel<SUB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DMMA_SMEM_BYTES));
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  syrk_ln_kernel<SUB><<<(int)blocks, DNT, DMMA_SMEM_BYTES, stream>>>(
      A, lda, C, ldc, M, K);
  CHECK(cudaGetLastError());
  return 0;
}

}  // namespace

// A (M, K), C (M, M) fp64, rows contiguous; M >= 1.  Returns a cudaError_t
// code.
extern "C" int syrk_ln_launch(const double* A, int lda, double* C, int ldc,
                              int M, int K, int device, void* stream) {
  return launch<false>(A, lda, C, ldc, M, K, device, stream);
}

// As syrk_ln_launch, but C's lower triangle -= A A^T in place.
extern "C" int syrk_ln_sub_launch(const double* A, int lda, double* C,
                                  int ldc, int M, int K, int device,
                                  void* stream) {
  return launch<true>(A, lda, C, ldc, M, K, device, stream);
}

extern "C" const char* syrk_ln_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The library's kernel functions for the resource query (tile.cuh's
// func_attrs): out[5] for function i, its name in *name.
extern "C" int syrk_ln_func_attrs(int i, int device, int* out,
                                  const char** name) {
  static const FuncInfo fs[] = {
      {(const void*)syrk_ln_kernel<false>, "syrk_ln_kernel<false>", DNT,
       DMMA_SMEM_BYTES},
      {(const void*)syrk_ln_kernel<true>, "syrk_ln_kernel<true>", DNT,
       DMMA_SMEM_BYTES},
  };
  return func_attrs(fs, (int)(sizeof(fs) / sizeof(fs[0])), i, device, out,
                    name);
}
