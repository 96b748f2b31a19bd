// Right-side lower-transposed triangular solve for Hopper, fp64: X L^T = B
// for L (W, W) lower triangular and B (M, W); rows contiguous, leading
// dimensions ldb, ldl, ldx.
//
// Replaces the TPU kernel src/repro/kernels/trsm.py::trsm_rlt
// (_first_step_kernel, _step_kernel) for any B: the TRSM the sequential
// path applies to a supernode's rectangular part after POTRF
// (ops.factor_panel).  Like the reference (and MAGMA) it never divides
// inside the kernel: the wrapper inverts the 64 x 64 diagonal blocks of L
// first, with the port's tri_inv_lower kernel where the reference calls an
// XLA triangular_solve, and this kernel does only products:
//
//     X_j = (B_j - X_{<j} L[j, <j]^T) invD_j^T      for block column j.
//
// Design: a row of X depends only on the same row of B, so one block of 256
// threads owns 64 rows of X and sweeps all block columns j in order inside
// one launch (the reference makes one pallas_call per block column, since
// its grid carries the order).  Per step, the 64 x 64 T = B_j - X_{<j}
// L[j, <j]^T is formed in shared memory by a tiled product over the block's
// own finished columns, then multiplied by invD_j^T and stored.  A block
// reads back only the columns of X it wrote itself, after a barrier, so no
// cross-block ordering is needed; those reads are plain (not read-only
// cache) loads.  invd is (ceil(W/64), 64, 64) with the last block's pad
// extended by the identity, so W need not be a multiple of 64; rows of B
// past M are masked.  L is read below the diagonal blocks only.
//
// Bound on this card: M W^2 flops against 8 (W (W+1)/2 + 2 M W) bytes:
// flop-bound at the fp64 tensor-core peak (67 TFLOP/s SXM) for the wide
// panels of the sequential path.  This first version does scalar fp64 FMAs
// and, with one block per 64 rows, fills only ceil(M/64) of the 132 SMs;
// DMMA tiles and splitting the columns of a step over blocks are left for
// later.
#include "tile.cuh"

namespace {

constexpr int NB = TILE;  // block column width == row tile height

__global__ void trsm_rlt_kernel(const double* B, int ldb, const double* L,
                                int ldl, const double* invd, double* X,
                                int ldx, int M, int W) {
  const int r0 = blockIdx.x * NB;
  const int nr = min(NB, M - r0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  __shared__ double As[TK * LDT], Bs[TK * LDT];
  __shared__ double T[NB * LDT];
  const double* Bb = B + (size_t)r0 * ldb;
  double* Xb = X + (size_t)r0 * ldx;
  for (int j0 = 0, jb = 0; j0 < W; j0 += NB, ++jb) {
    const int nbj = min(NB, W - j0);
    double acc[4][4] = {};
    // acc = X[:, :j0] L[j0:j0+nbj, :j0]^T over this block's rows
    gemm_nt_tile(Xb, ldx, nr, L + (size_t)j0 * ldl, ldl, nbj, j0, acc, As,
                 Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        T[r * LDT + col] = (r < nr && col < nbj)
                               ? Bb[(size_t)r * ldb + j0 + col] - acc[i][c]
                               : 0.0;
        acc[i][c] = 0.0;
      }
    __syncthreads();
    // X_j = T invD_j^T; the sum stops at nbj: T is zero past it, and the
    // identity pad makes invD_j's real rows zero past it
    gemm_nt_tile(T, LDT, nr, invd + (size_t)jb * NB * NB, NB, nbj, nbj, acc,
                 As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        if (r < nr && col < nbj) Xb[(size_t)r * ldx + j0 + col] = acc[i][c];
      }
    // the next step reads these columns back, and reuses T
    __syncthreads();
  }
}

}  // namespace

// B, X: (M, W); L: (W, W); invd: (ceil(W/64), 64, 64) contiguous; fp64, rows
// contiguous, M, W >= 1.  Returns a cudaError_t code.
extern "C" int trsm_rlt_launch(const double* B, int ldb, const double* L,
                               int ldl, const double* invd, double* X, int ldx,
                               int M, int W, int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  trsm_rlt_kernel<<<(M + NB - 1) / NB, NT, 0, stream>>>(B, ldb, L, ldl, invd,
                                                        X, ldx, M, W);
  CHECK(cudaGetLastError());
  return 0;
}

extern "C" const char* trsm_rlt_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
