// Batched lower-triangular inverse for Hopper: X[b] = L[b]^{-1} over a
// stack of Bp lanes of Wp x Wp fp64, strict upper triangle of X zero.
//
// Replaces the TPU kernel src/repro/kernels/trsm.py::trsm_rlt
// (_first_step_kernel, _step_kernel, _invert_diag_blocks) as it is used on
// the solve path: engines._invert_diag_fn runs ops.trsm_lln(L, I) on every
// lane of a group, which computes L^{-1}.  This kernel computes that batched
// inverse directly.  Diagonal blocks arrive with their identity extension,
// so pad columns invert to identity.  Only L's lower triangle is used.
//
// Design: recursive doubling over 64-wide blocks (nblk = ceil(Wp / 64); the
// last block may be partial, so Wp need not be a multiple of 64):
//   1. inv_diag_kernel, one block of 4 warps per (lane, diagonal block),
//      inverts L_jj in shared memory: the 8 x 8 diagonal inverses by forward
//      substitution, then tile.cuh's doubling on DMMA (mma.sync m16n8k8
//      f64); it writes the whole 64 x 64 block of X, zeros above the
//      diagonal included;
//   2. for block counts g = 1, 2, 4, ... below nblk, a level of pairs of
//      h = 64 g wide halves [s0, s1) and [s1, e2), e2 = min(s1 + h, Wp)
//      (an odd last group has no partner and carries up a level):
//          level_t_kernel   T   = L21 X11       (L21 = L[s1:e2, s0:s1])
//          level_x_kernel   X21 = -X22 T,       and X12 = 0
//      each a grid of one DMMA tile (tile.cuh: dmma_tile_nn) per 64 x 64
//      output tile of every pair of every lane.  X11 and X22 are lower
//      triangular, so each tile's K range starts (T) or stops (X21) at the
//      diagonal tile: Wp^3 / 3 flops in all.  T lives in a scratch buffer
//      the wrapper passes, ts doubles a lane (the largest level's pairs).
// Launches per call: 1 + 2 ceil(log2 nblk), so 11 at Wp = 2048 (the
// column-serial first version took a memset and 1 + 31).  Lanes and tiles
// share gridDim.x, so any lane count launches (gridDim.y stops at 65,535).
//
// Bound on this card: Wp^3/3 flops per lane against the lower triangle
// read and the whole X written (8 (Wp^2/2 + Wp^2) bytes), so the large
// lanes are flop-bound at the fp64 tensor-core peak (67 TFLOP/s SXM, 51
// PCIe) and the small ones byte-bound at 3.35 TB/s (2.0 PCIe).  The
// products run on DMMA; the level count, not one launch per block row,
// sets the launches.
#include "tile.cuh"

namespace {

constexpr int INT = 128;  // threads of inv_diag_kernel (4 warps)
// L_jj and its inverse (rows of TLD) and the doubling's products: 78,848
// bytes, so two blocks fit an SM
constexpr int DIAG_SMEM = (2 * DT * TLD + TPSZ) * (int)sizeof(double);

__global__ void __launch_bounds__(INT)
    inv_diag_kernel(const double* __restrict__ L, int ldl, int lsl,
                    double* __restrict__ X, int Wp, int nblk) {
  const int b = blockIdx.x / nblk, j0 = (blockIdx.x % nblk) * DT;
  const int n = min(DT, Wp - j0), tid = threadIdx.x;
  extern __shared__ __align__(16) double sm[];
  double* D = sm;               // L_jj, padded with the identity
  double* Li = D + DT * TLD;    // its inverse
  double* P = Li + DT * TLD;    // the doubling's products
  const double* Ljj = L + (size_t)b * lsl + (size_t)j0 * ldl + j0;
  dmma_stage<DT, TLD, INT>(D, Ljj, ldl, n, n, 0, dmma_vec(Ljj, ldl));
  cp_async_commit();
  for (int e = tid; e < DT * DT; e += INT) Li[(e / DT) * TLD + e % DT] = 0.0;
  cp_async_wait<0>();
  __syncthreads();
  for (int i = n + tid; i < DT; i += INT) D[i * TLD + i] = 1.0;
  __syncthreads();
  tri_inv8_diag(D, Li);
  __syncthreads();
  tri_inv64_doubling(D, Li, P);
  __syncthreads();
  double* Xb = X + (size_t)b * Wp * Wp + (size_t)j0 * Wp + j0;
  for (int e = tid; e < n * n; e += INT) {
    const int i = e / n, c = e % n;
    Xb[(size_t)i * Wp + c] = Li[i * TLD + c];
  }
}

// One output tile of a level: blockIdx.x = ((b npairs + p) g + rt) g + ct
// for lane b, pair p, row tile rt and column tile ct (g = h / 64).  Sets the
// pair's bounds and returns false for a row tile past e2.
struct LevelTile {
  int b, p, rt, ct, s0, s1, e2, r0, c0;
  __device__ bool init(int Wp, int h, int npairs) {
    const int g = h / DT;
    unsigned idx = blockIdx.x;
    ct = idx % g;
    idx /= g;
    rt = idx % g;
    idx /= g;
    p = idx % npairs;
    b = idx / npairs;
    s0 = 2 * p * h;
    s1 = s0 + h;
    e2 = min(s1 + h, Wp);
    r0 = s1 + rt * DT;
    c0 = s0 + ct * DT;
    return r0 < e2;
  }
};

// T = L21 X11 for one 64 x 64 tile: k runs from the tile's column c0 (X11 is
// zero above its diagonal) to s1.  T of pair p: rows [p h, p h + e2 - s1)
// of the lane's (npairs h) x h scratch.
__global__ void __launch_bounds__(DNT)
    level_t_kernel(const double* __restrict__ L, int ldl, int lsl,
                   const double* __restrict__ X, double* __restrict__ T,
                   int ts, int Wp, int h, int npairs) {
  LevelTile t;
  if (!t.init(Wp, h, npairs)) return;
  extern __shared__ __align__(16) double sm[];
  double acc[2][16 / DNW][4] = {};
  const int nr = min(DT, t.e2 - t.r0);
  dmma_tile_nn(L + (size_t)t.b * lsl + (size_t)t.r0 * ldl + t.c0, ldl, nr,
               X + (size_t)t.b * Wp * Wp + (size_t)t.c0 * Wp + t.c0, Wp, DT,
               t.s1 - t.c0, acc, sm);
  double* Tt = T + (size_t)t.b * ts + (size_t)(t.p * h + t.rt * DT) * h +
               t.ct * DT;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16 / DNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = dmma_row<DNW>(i, e), c = dmma_col<DNW>(j, e);
        if (r < nr) Tt[(size_t)r * h + c] = acc[i][j][e];
      }
}

// X21 = -X22 T for one 64 x 64 tile: k runs from s1 to the end of the
// tile's rows (X22 is zero above its diagonal).  The block also zeroes the
// mirror tile of X12, which nothing reads: the strict upper triangle of X
// is the union of the pairs' X12 and the diagonal blocks' upper halves.
__global__ void __launch_bounds__(DNT)
    level_x_kernel(const double* __restrict__ T, int ts, double* X, int Wp,
                   int h, int npairs) {
  LevelTile t;
  if (!t.init(Wp, h, npairs)) return;
  extern __shared__ __align__(16) double sm[];
  double acc[2][16 / DNW][4] = {};
  const int nr = min(DT, t.e2 - t.r0);
  double* Xb = X + (size_t)t.b * Wp * Wp;
  dmma_tile_nn(Xb + (size_t)t.r0 * Wp + t.s1, Wp, nr,
               T + (size_t)t.b * ts + (size_t)t.p * h * h + t.ct * DT, h, DT,
               t.r0 + nr - t.s1, acc, sm);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16 / DNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = dmma_row<DNW>(i, e), c = dmma_col<DNW>(j, e);
        if (r < nr) Xb[(size_t)(t.r0 + r) * Wp + t.c0 + c] = -acc[i][j][e];
      }
  for (int e = threadIdx.x; e < DT * nr; e += DNT) {
    const int i = e / nr, c = e % nr;
    Xb[(size_t)(t.c0 + i) * Wp + t.r0 + c] = 0.0;
  }
}

// Pairs of the level with g-block halves, over nblk blocks.
int level_pairs(int nblk, int g) { return (nblk - g + 2 * g - 1) / (2 * g); }

}  // namespace

// L: Bp lanes of (Wp, Wp) fp64 at lane stride lsl, rows at stride ldl
// (unit column stride); X: (Bp, Wp, Wp) contiguous; T: Bp * ts doubles of
// scratch, ts = the largest npairs * h * h of the levels (0 when Wp <= 64).
// Bp, Wp >= 1.  Returns a cudaError_t code.
extern "C" int tri_inv_lower_launch(const double* L, int ldl, int lsl,
                                    double* X, double* T, int ts, int Bp,
                                    int Wp, int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  static bool allowed[64];  // the dynamic shared memory, once per device
  if (!(device >= 0 && device < 64 && allowed[device])) {
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    CHECK(cudaFuncSetAttribute(inv_diag_kernel, attr, DIAG_SMEM));
    CHECK(cudaFuncSetAttribute(level_t_kernel, attr, DMMA_SMEM_BYTES));
    CHECK(cudaFuncSetAttribute(level_x_kernel, attr, DMMA_SMEM_BYTES));
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  const int nblk = (Wp + DT - 1) / DT;
  if ((long long)Bp * nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  inv_diag_kernel<<<Bp * nblk, INT, DIAG_SMEM, stream>>>(L, ldl, lsl, X,
                                                          Wp, nblk);
  CHECK(cudaGetLastError());
  for (int g = 1; g < nblk; g *= 2) {
    const int h = DT * g, npairs = level_pairs(nblk, g);
    const long long tiles = (long long)Bp * npairs * g * g;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    level_t_kernel<<<(unsigned)tiles, DNT, DMMA_SMEM_BYTES, stream>>>(
        L, ldl, lsl, X, T, ts, Wp, h, npairs);
    CHECK(cudaGetLastError());
    level_x_kernel<<<(unsigned)tiles, DNT, DMMA_SMEM_BYTES, stream>>>(
        T, ts, X, Wp, h, npairs);
    CHECK(cudaGetLastError());
  }
  return 0;
}

extern "C" const char* tri_inv_lower_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The library's kernel functions for the resource query (tile.cuh's
// func_attrs): out[5] for function i, its name in *name.
extern "C" int tri_inv_func_attrs(int i, int device, int* out,
                                  const char** name) {
  static const FuncInfo fs[] = {
      {(const void*)inv_diag_kernel, "inv_diag_kernel", INT, DIAG_SMEM},
      {(const void*)level_t_kernel, "level_t_kernel", DNT, DMMA_SMEM_BYTES},
      {(const void*)level_x_kernel, "level_x_kernel", DNT, DMMA_SMEM_BYTES},
  };
  return func_attrs(fs, (int)(sizeof(fs) / sizeof(fs[0])), i, device, out,
                    name);
}
