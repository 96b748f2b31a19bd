// Unblocked Cholesky of one diagonal tile for Hopper, fp64: L = chol(A) for
// A (n, n), n <= 128, read from its lower triangle only; L lower with the
// strict upper triangle zero.  Rows contiguous, leading dimensions lda, ldl.
//
// Replaces the TPU kernel src/repro/kernels/potrf.py::chol_tile
// (_chol_tile_kernel): the whole (nb, nb) tile in VMEM, factored by a loop
// of rank-1 updates on the vector unit.  The blocked routine potrf (the
// port's kernels/potrf.py) calls it once per 128-column step, and chains
// tri_inv_lower, gemm_nt and syrk_ln around it as the reference does.
//
// Design: one block of 256 threads holds the tile in dynamic shared memory
// (128 x 129 fp64 = 132 KB with a padded row stride, inside the 227 KB a
// block may take).  Column j: every thread waits for column j to be final,
// takes d = sqrt(a_jj), scales the column below the diagonal, then updates
// the trailing lower triangle a_ip -= l_ij l_pj (p <= i) in parallel.  Only
// cells on or below the diagonal are loaded, so the upper triangle of A is
// never read: the sequential path's panels hold only the lower triangle.  A
// non-positive pivot gives NaN, as the reference's sqrt does.
//
// Bound on this card: n^3/3 flops (0.7 MFLOP at n = 128) against
// 8 (n (n+1)/2 + n^2) bytes, so the bound is bytes at 3.35 TB/s (about
// 0.06 us); what bounds this kernel is latency instead: n dependent steps,
// two block barriers each, on a single SM.  The routine runs it once per
// 128 columns, so it is a small, fixed share of a large potrf.
#include <cuda_runtime.h>

namespace {

constexpr int MAXN = 128;
constexpr int LDS = MAXN + 1;
constexpr int NT = 256;
constexpr int SMEM = MAXN * LDS * (int)sizeof(double);

__global__ void chol_tile_kernel(const double* __restrict__ A, int lda,
                                 double* __restrict__ L, int ldl, int n) {
  extern __shared__ double S[];
  const int tid = threadIdx.x;
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n, p = e % n;
    S[i * LDS + p] = p <= i ? A[(size_t)i * lda + p] : 0.0;
  }
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    const double d = sqrt(S[j * LDS + j]);
    for (int i = j + 1 + tid; i < n; i += NT) S[i * LDS + j] /= d;
    __syncthreads();
    if (tid == 0) S[j * LDS + j] = d;
    const int rem = n - j - 1;
    for (int e = tid; e < rem * rem; e += NT) {
      const int i = j + 1 + e / rem, p = j + 1 + e % rem;
      if (p <= i) S[i * LDS + p] -= S[i * LDS + j] * S[p * LDS + j];
    }
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n, p = e % n;
    L[(size_t)i * ldl + p] = p <= i ? S[i * LDS + p] : 0.0;
  }
}

}  // namespace

#define CHECK(x)                                  \
  do {                                            \
    cudaError_t err_ = (x);                       \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// A, L: (n, n) fp64, rows contiguous, 1 <= n <= 128.  Returns a
// cudaError_t code.
extern "C" int chol_tile_launch(const double* A, int lda, double* L, int ldl,
                                int n, int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  CHECK(cudaFuncSetAttribute(chol_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM));
  chol_tile_kernel<<<1, NT, SMEM, stream>>>(A, lda, L, ldl, n);
  CHECK(cudaGetLastError());
  return 0;
}

extern "C" const char* chol_tile_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
