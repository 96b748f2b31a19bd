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
// Bound on this card: 2 M N K flops against 8 (M K + N K + M N) bytes, so
// the large products are flop-bound at the fp64 tensor-core peak
// (67 TFLOP/s SXM) and the thin ones byte-bound at 3.35 TB/s.  fp64 reaches
// the tensor cores only through mma.sync DMMA (wgmma has no fp64 form).
//
// Design: one block of 256 threads (8 warps) per 64 x 64 output tile on the
// DMMA tile of tile.cuh (dmma_tile_nt: mma.sync.aligned.m16n8k8 f64, K in
// chunks of 32 staged by cp.async three deep in shared memory, 16-byte
// copies where the operand's address and ld allow, 8-byte ones otherwise).
// Edges are masked, so M, N and K take any value and nothing is padded:
// the rows [Wp + k0, Wp + k1) the reference slices out of a bucket-padded
// buffer are here the exact rows of the panel, at odd widths and offsets.
//   Grid: at the sequential path's largest RLB pair (580 x 620 x 669 on
// lap3d_40) 64 x 64 tiles give 10 x 10 = 100 blocks, about one per SM of
// the 132, each running 21 K chunks; that is enough blocks in flight, so
// there is no split along K (it would need a second pass or atomics, and
// fp64 atomics would make the sum's order vary from run to run).  Smaller
// tiles would double the operand reloads for the same grid.  The many
// small RLB blocks are one or a few tiles, each on one SM: their time is
// the launch, the host wrapper around it, and one tile's 21 chunks.
#include "tile.cuh"

namespace {

__global__ void __launch_bounds__(DNT)
    gemm_nt_kernel(const double* __restrict__ A, int lda,
                   const double* __restrict__ B, int ldb,
                   double* __restrict__ C, int ldc, int M, int N, int K) {
  const int r0 = blockIdx.y * DT, c0 = blockIdx.x * DT;
  extern __shared__ __align__(16) double sm[];
  double acc[2][16 / DNW][4] = {};
  dmma_tile_nt(A + (size_t)r0 * lda, lda, min(DT, M - r0),
               B + (size_t)c0 * ldb, ldb, min(DT, N - c0), K, acc, sm);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16 / DNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + dmma_row<DNW>(i, e), c = c0 + dmma_col<DNW>(j, e);
        if (r < M && c < N) C[(size_t)r * ldc + c] = acc[i][j][e];
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
  const dim3 grid((N + DT - 1) / DT, (M + DT - 1) / DT);
  static bool allowed[64];  // the dynamic shared memory, once per device
  if (!(device >= 0 && device < 64 && allowed[device])) {
    CHECK(cudaFuncSetAttribute(gemm_nt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DMMA_SMEM_BYTES));
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  gemm_nt_kernel<<<grid, DNT, DMMA_SMEM_BYTES, stream>>>(A, lda, B, ldb, C,
                                                         ldc, M, N, K);
  CHECK(cudaGetLastError());
  return 0;
}

extern "C" const char* gemm_nt_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
