// Batched lower-triangular inverse for Hopper: X[b] = L[b]^{-1} over a
// (Bp, Wp, Wp) fp64 stack, strict upper triangle of X zero.
//
// Replaces the TPU kernel src/repro/kernels/trsm.py::trsm_rlt
// (_first_step_kernel, _step_kernel, _invert_diag_blocks) as it is used on
// the solve path: engines._invert_diag_fn runs ops.trsm_lln(L, I) on every
// lane of a group, which computes L^{-1}.  This kernel computes that batched
// inverse directly.  Diagonal blocks arrive with their identity extension,
// so pad columns invert to identity.
//
// Design, with 64 x 64 blocks (nb = min(64, Wp); the last block may be
// partial, so Wp need not be a multiple of 64 or of 128):
//   1. X is zeroed (one memset): the upper triangle is never computed;
//   2. diag_inv_kernel, one block of threads per (diagonal block, lane),
//      inverts L_jj in shared memory by a row sweep of forward substitution;
//   3. for each block row i = 1 .. nblk-1, offdiag_kernel over
//      (block column j < i, lane) computes
//          X_ij = -X_ii * sum_{k=j}^{i-1} L_ik X_kj
//      as two tiled fp64 GEMMs (the K loop reads block rows j..i-1 of X,
//      finished by earlier launches).
//
// Bound on this card: Wp^3/3 flops per lane against 2 Wp^2 * 8 bytes, so the
// large lanes are flop-bound at the fp64 tensor-core peak (67 TFLOP/s SXM,
// 51 PCIe) and the small ones byte-bound at 3.35 TB/s (2.0 PCIe).  This
// first version uses scalar fp64 FMAs in 64 x 64 tiles, and block rows run
// one launch each; DMMA tiles and one persistent launch are left for later.
#include <cuda_runtime.h>

namespace {

constexpr int NB = 64;
constexpr int TK = 8;
constexpr int NT = 256;
constexpr int DIAG_SMEM = 2 * NB * NB * (int)sizeof(double);

// acc[i][j] += sum_k A[r][k] * B[k][c] for r = ty + 16 i, c = tx + 16 j,
// k in [0, K); A row-major with k contiguous, B row-major with c
// contiguous.  Rows of A past arows and columns of B past bcols read as 0.
__device__ __forceinline__ void gemm_nn_tile(
    const double* A, int lda, int arows, const double* B, int ldb, int bcols,
    int K, double (&acc)[4][4], double* As, double* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < NB * TK; e += NT) {
      const int r = e / TK, k = e % TK;
      As[k * (NB + 1) + r] =
          (r < arows && k0 + k < K) ? A[(size_t)r * lda + k0 + k] : 0.0;
      const int kb = e / NB, c = e % NB;
      Bs[kb * (NB + 1) + c] =
          (c < bcols && k0 + kb < K) ? B[(size_t)(k0 + kb) * ldb + c] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k * (NB + 1) + ty + 16 * i];
        b[i] = Bs[k * (NB + 1) + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void diag_inv_kernel(const double* __restrict__ L,
                                double* __restrict__ X, int Wp) {
  const int j0 = blockIdx.x * NB, b = blockIdx.y, tid = threadIdx.x;
  const int n = min(NB, Wp - j0);
  extern __shared__ double sm[];
  double* D = sm;            // L_jj, lower
  double* Y = sm + NB * NB;  // its inverse, built row by row
  const double* Lb = L + (size_t)b * Wp * Wp;
  double* Xb = X + (size_t)b * Wp * Wp;
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n, c = e % n;
    D[i * NB + c] = c <= i ? Lb[(size_t)(j0 + i) * Wp + j0 + c] : 0.0;
    Y[i * NB + c] = i == c ? 1.0 : 0.0;
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    // row j of the inverse is final once divided by the pivot
    for (int c = tid; c <= j; c += NT) Y[j * NB + c] /= D[j * NB + j];
    __syncthreads();
    const int rem = n - j - 1;
    for (int e = tid; e < rem * (j + 1); e += NT) {
      const int i = j + 1 + e / (j + 1), c = e % (j + 1);
      Y[i * NB + c] -= D[i * NB + j] * Y[j * NB + c];
    }
    __syncthreads();
  }
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n, c = e % n;
    if (c <= i) Xb[(size_t)(j0 + i) * Wp + j0 + c] = Y[i * NB + c];
  }
}

__global__ void offdiag_kernel(const double* __restrict__ L,
                               double* __restrict__ X, int Wp, int ib) {
  const int jb = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int i0 = ib * NB, j0 = jb * NB;
  const int ni = min(NB, Wp - i0);  // jb < ib, so block column jb is full
  __shared__ double As[TK * (NB + 1)], Bs[TK * (NB + 1)];
  __shared__ double Ts[NB * NB];
  const double* Lb = L + (size_t)b * Wp * Wp;
  double* Xb = X + (size_t)b * Wp * Wp;
  const int tx = tid % 16, ty = tid / 16;
  double acc[4][4] = {};
  // T = L[i0:i0+ni, j0:i0] X[j0:i0, j0:j0+NB]
  gemm_nn_tile(Lb + (size_t)i0 * Wp + j0, Wp, ni, Xb + (size_t)j0 * Wp + j0,
               Wp, NB, i0 - j0, acc, As, Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Ts[(ty + 16 * i) * NB + tx + 16 * j] = acc[i][j];
      acc[i][j] = 0.0;
    }
  __syncthreads();
  // X_ij = -X_ii T
  gemm_nn_tile(Xb + (size_t)i0 * Wp + i0, Wp, ni, Ts, NB, NB, ni, acc, As,
               Bs);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i;
      if (r < ni) Xb[(size_t)(i0 + r) * Wp + j0 + tx + 16 * j] = -acc[i][j];
    }
}

}  // namespace

#define CHECK(x)                                  \
  do {                                            \
    cudaError_t err_ = (x);                       \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// L, X: (Bp, Wp, Wp) fp64, contiguous.  Returns a cudaError_t code.
extern "C" int tri_inv_lower_launch(const double* L, double* X, int Bp, int Wp,
                                    int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  CHECK(cudaFuncSetAttribute(diag_inv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DIAG_SMEM));
  CHECK(cudaMemsetAsync(X, 0, sizeof(double) * (size_t)Bp * Wp * Wp, stream));
  const int nblk = (Wp + NB - 1) / NB;
  diag_inv_kernel<<<dim3(nblk, Bp), NT, DIAG_SMEM, stream>>>(L, X, Wp);
  CHECK(cudaGetLastError());
  for (int ib = 1; ib < nblk; ++ib) {
    offdiag_kernel<<<dim3(ib, Bp), NT, 0, stream>>>(L, X, Wp, ib);
    CHECK(cudaGetLastError());
  }
  return 0;
}

extern "C" const char* tri_inv_lower_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
