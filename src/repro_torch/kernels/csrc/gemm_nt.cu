// Dense C = A B^T for Hopper, fp64: A (M, K), B (N, K), C (M, N); rows of
// each matrix are contiguous, with leading dimensions lda, ldb, ldc.
//
// Replaces the TPU kernel src/repro/kernels/gemm.py::gemm_nt
// (_gemm_nt_kernel): 128 x 128 output tiles fed to the MXU by a sequential
// K reduction, on operands that ops.gemm_nt zero-pads to multiples of 128.
// On the sequential path it computes RLB's off-diagonal block updates
// (engines._gemm_block_fn) and, inside the blocked potrf routine, the panel
// below each diagonal tile times that tile's inverse.
//
// Design: one block of 256 threads per 64 x 64 output tile, each thread
// holding a 4 x 4 accumulator; A and B stream through shared memory in
// K-chunks of 8 (the tile loop of tile.cuh).  Edges are masked, so M, N
// and K take any value and nothing is padded: the rows
// [Wp + k0, Wp + k1) the reference slices out of a bucket-padded buffer are
// here the exact rows of the panel.
//
// Bound on this card: 2 M N K flops against 8 (M K + N K + M N) bytes, so
// the large products are flop-bound at the fp64 tensor-core peak
// (67 TFLOP/s SXM) and the thin ones byte-bound at 3.35 TB/s.  This first
// version does scalar fp64 FMAs (at most the 34 TFLOP/s non-tensor rate,
// and shared-memory bound well below it); RLB's many small blocks are bound
// by the launch and the host round trip around it instead.  DMMA
// (mma.sync f64) tiles and TMA staging are left for later.
#include "tile.cuh"

namespace {

__global__ void gemm_nt_kernel(const double* __restrict__ A, int lda,
                               const double* __restrict__ B, int ldb,
                               double* __restrict__ C, int ldc, int M, int N,
                               int K) {
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  __shared__ double As[TK * LDT], Bs[TK * LDT];
  double acc[4][4] = {};
  gemm_nt_tile(A + (size_t)r0 * lda, lda, min(TILE, M - r0),
               B + (size_t)c0 * ldb, ldb, min(TILE, N - c0), K, acc, As, Bs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r < M && c < N) C[(size_t)r * ldc + c] = acc[i][j];
    }
}

}  // namespace

// A (M, K), B (N, K), C (M, N) fp64, rows contiguous; M, N >= 1.  Returns a
// cudaError_t code.
extern "C" int gemm_nt_launch(const double* A, int lda, const double* B,
                              int ldb, double* C, int ldc, int M, int N,
                              int K, int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  gemm_nt_kernel<<<grid, NT, 0, stream>>>(A, lda, B, ldb, C, ldc, M, N, K);
  CHECK(cudaGetLastError());
  return 0;
}

extern "C" const char* gemm_nt_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
