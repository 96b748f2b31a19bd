// Cholesky of one diagonal tile for Hopper, fp64: L = chol(A) for A (n, n),
// n <= 128, read from its lower triangle only; L lower with the strict upper
// triangle zero.  Rows contiguous, leading dimensions lda, ldl; L may be A
// itself (the tile is read whole before anything is written).
//
// Replaces the TPU kernel src/repro/kernels/potrf.py::chol_tile
// (_chol_tile_kernel): the whole (nb, nb) tile in VMEM, factored by a loop
// of rank-1 updates on the vector unit.  The blocked routine potrf (the
// port's kernels/potrf.py) calls it once per 128-column step, with
// trsm_rlt and the subtract form of syrk_ln around it.
//
// Design: one block holds the tile in shared memory, padded to NP x NP
// (NP = 8, 16, 32, 64 or 128, the least that holds n; rows past n hold the
// identity) and factored in place by the blocked right-looking scheme of
// the fused panel kernel (fused_factor_syrk.cu), in 8-wide sub-blocks:
//   * one warp factors the 8 x 8 diagonal sub-block J in registers with
//     shuffles (tile.cuh's chol8_rsqrt, shared with the panel kernel) -- a
//     pivot x gives r = rsqrt(x), L_jj = x r and the column below scaled
//     by r, so there is no division -- and forms its inverse
//     D_J by right-looking substitution, a column a lane;
//   * the rows below, L[r][J] = A[r][J] D_J^T, as 16 x 8 fp64 tensor-core
//     fragments (mma.sync m16n8k8 f64, DMMA), a warp per 16-row tile;
//   * the trailing lower triangle, L[r][c] -= L[r][J] L[c][J], as 16 x 8
//     DMMA fragments spread over the warps, while warp 0 looks ahead: it
//     updates the fragment that holds diagonal sub-block J + 1 first and
//     factors it while the others finish.
// The tile comes in by cp.async, every cell's copy in flight at once.
// That is two block barriers per 8 columns, ceil(n / 8) - 1 steps (15 at
// n = 128, where a column-serial sweep takes 128 steps of two), and the
// steps and fragments stop at the tile's real extent, so n = 65 takes 8
// steps in the 128 variant.  NP / 16 warps (one for NP <= 16): a tile of
// n <= 8 is one warp and one diagonal factor, with no update.  The variant
// sets its dynamic shared memory attribute once per device (only NP = 128,
// 147,456 bytes, is above the 48 KB default).  Only cells on or below the
// diagonal are read from A or written in shared memory (the sequential
// path's panels hold only the lower triangle); the strict upper triangle
// of L is written as zero.  A non-positive pivot gives NaN from its column
// on (rsqrt of 0 is inf, and 0 inf is NaN), as the reference's sqrt does.
//
// Bound on this card: n^3/3 flops (0.7 MFLOP at n = 128) against
// 8 (n (n+1)/2 + n^2) bytes, so the bound is bytes at 3.35 TB/s (about
// 0.06 us at n = 128).  What holds the kernel back is latency instead: one
// SM, ceil(n / 8) - 1 dependent steps, each a chain of shuffles in one
// warp (the 8 x 8 factor and inverse) between two barriers.  A tile is too
// small to spread over SMs; the gain left is in the host's call around it.
#include "tile.cuh"

namespace {

constexpr int SB = 8;       // sub-block width
constexpr int DS = SB + 4;  // stride of an 8 x 8 inverse (conflict-free)

template <int NP>
struct Tile {
  static constexpr int NW = NP >= 32 ? NP / 16 : 1;  // warps
  static constexpr int LD = NP + 4;                  // row stride (4 mod 16)
  static constexpr int NSB = NP / SB;                // diagonal sub-blocks
  // the tile, then the 8 x 8 inverses of the sub-blocks with rows below
  static constexpr int SMEM = (NP * LD + NSB * SB * DS) * (int)sizeof(double);
};

template <int NP>
__global__ void __launch_bounds__(32 * Tile<NP>::NW)
    chol_tile_kernel(const double* A, int lda, double* L, int ldl, int n) {
  constexpr int NW = Tile<NP>::NW, LD = Tile<NP>::LD;
  extern __shared__ __align__(16) double sm[];
  double* S = sm;            // the tile, factored in place
  double* D = S + NP * LD;   // D_J = inverse of diagonal sub-block J
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsb = (n + SB - 1) / SB;  // sub-blocks holding a real column
  // rows the 16-row fragments reach: [0, nr)
  const int nr = NP < 16 ? NP : min(NP, (n + 15) & ~15);
  // the lower triangle of A by cp.async, so every copy is in flight at
  // once (a load then a store would wait out a load's latency per cell);
  // rows past n hold the identity
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(S);
  for (int i = warp; i < nr; i += NW)
    for (int p = lane; p <= i; p += 32) {
      if (i < n)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         s0 + 8u * (i * LD + p)),
                     "l"(A + (size_t)i * lda + p));
      else
        S[i * LD + p] = p == i ? 1.0 : 0.0;
    }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Warp 0 factors diagonal sub-block J (serial in its 8 columns) and, if
  // rows lie below it, forms its inverse D_J.  Lane i (mod 8) holds row
  // j0 + i; cells above the diagonal are read but never used, and written
  // as zero.
  auto factor_diag = [&](int J, bool inv) {
    const int j0 = J * SB, i = lane & (SB - 1);
    double a[SB], rq[SB];
#pragma unroll
    for (int p = 0; p < SB; ++p) a[p] = S[(j0 + i) * LD + j0 + p];
    chol8_rsqrt(a, rq, i);
    if (lane < SB) {
#pragma unroll
      for (int p = 0; p < SB; ++p) S[(j0 + i) * LD + j0 + p] = a[p];
    }
    if (!inv) return;
    // column i of D_J by right-looking substitution: x = e_i, then for each
    // r, x[r] /= L[r][r] and x[p] -= L[p][r] x[r] below it, with L[p][r]
    // read from lane p (the shuffles do not wait on x, and the chain is
    // 8 steps deep where the left-looking sums make it 36)
    double x[SB];
#pragma unroll
    for (int r = 0; r < SB; ++r) x[r] = r == i ? 1.0 : 0.0;
#pragma unroll
    for (int r = 0; r < SB; ++r) {
      x[r] = r < i ? 0.0 : x[r] * rq[r];
#pragma unroll
      for (int p = r + 1; p < SB; ++p)
        x[p] -= __shfl_sync(0xffffffffu, a[r], p) * x[r];
    }
    if (lane < SB) {
#pragma unroll
      for (int p = 0; p < SB; ++p) D[J * SB * DS + p * DS + i] = x[p];
    }
  };
  if (warp == 0) factor_diag(0, nsb > 1);
  __syncthreads();
  for (int J = 0; J + 1 < nsb; ++J) {
    const int j0 = J * SB;
    // 16-row tiles (at multiples of 16) that hold rows >= j0 + 8
    const int lo = j0 + SB, mt0 = (lo / 16) * 16;
    const int nmt = (nr - mt0) / 16;
    // the rows below: L[r][j0 + c] = sum_p A[r][j0 + p] D_J[c][p], a warp
    // per 16-row tile (it reads and writes only its own rows)
    if (warp < nmt) {
      const int r0 = mt0 + 16 * warp;
      double a[4], bb[2], c[4] = {0.0, 0.0, 0.0, 0.0};
      frag_a(a, S, LD, r0, j0);
      frag_bt(bb, D + J * SB * DS, DS, 0, 0);
      dmma(c, a, bb);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(r0, e);
        if (r >= lo) S[r * LD + j0 + frag_col(0, e)] = c[e];
      }
    }
    __syncthreads();
    // the trailing lower triangle: S[r][c] -= sum_p S[r][j0 + p] S[c][j0 + p]
    // for lo <= c <= r and c below the last real sub-block's end, as
    // 16 x 8 fragments (tasks); task 0 holds the next diagonal sub-block.
    // Two tasks at a time, so their loads overlap.
    const int nnt = nsb - J - 1, ntask = nmt * nnt;
    auto trail = [&](int t, int u) {
      double a[2][4], bb[2][2], c[2][4];
      int r0[2], c0[2];
      bool on[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = h ? u : t;
        r0[h] = mt0 + 16 * (k / nnt);
        c0[h] = lo + SB * (k % nnt);
        on[h] = k < ntask && r0[h] + 15 >= c0[h];  // else above the diagonal
        if (!on[h]) continue;
        frag_a(a[h], S, LD, r0[h], j0);
        frag_bt(bb[h], S, LD, c0[h], j0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[h][e] = S[frag_row(r0[h], e) * LD + frag_col(c0[h], e)];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!on[h]) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) a[h][e] = -a[h][e];
        dmma(c[h], a[h], bb[h]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!on[h]) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = frag_row(r0[h], e), cc = frag_col(c0[h], e);
          if (r >= lo && r >= cc) S[r * LD + cc] = c[h][e];
        }
      }
    };
    if (warp == 0) {
      trail(0, NW > 1 ? ntask : 1);
      if constexpr (NW == 1)  // no other warp: warp 0 takes every task
        for (int t = 2; t < ntask; t += 2) trail(t, t + 1);
      __syncwarp();
      factor_diag(J + 1, J + 2 < nsb);
    } else {
      constexpr int OTHERS = NW > 1 ? NW - 1 : 1;
      for (int t = warp; t < ntask; t += 2 * OTHERS) trail(t, t + OTHERS);
    }
    __syncthreads();
  }
  for (int i = warp; i < n; i += NW)
    for (int p = lane; p < n; p += 32)
      L[(size_t)i * ldl + p] = p <= i ? S[i * LD + p] : 0.0;
}

template <int NP>
cudaError_t launch(const double* A, int lda, double* L, int ldl, int n,
                   int device, cudaStream_t stream) {
  constexpr int SMEM = Tile<NP>::SMEM;
  if constexpr (SMEM > 48 * 1024) {  // the attribute, once per device
    static bool allowed[64];
    if (!(device >= 0 && device < 64 && allowed[device])) {
      const cudaError_t err = cudaFuncSetAttribute(
          chol_tile_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM);
      if (err != cudaSuccess) return err;
      if (device >= 0 && device < 64) allowed[device] = true;
    }
  }
  chol_tile_kernel<NP><<<1, 32 * Tile<NP>::NW, SMEM, stream>>>(A, lda, L,
                                                               ldl, n);
  return cudaGetLastError();
}

}  // namespace

// A, L: (n, n) fp64, rows contiguous, 1 <= n <= 128; L may be A.  Returns
// a cudaError_t code.
extern "C" int chol_tile_launch(const double* A, int lda, double* L, int ldl,
                                int n, int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  if (n <= 8) return launch<8>(A, lda, L, ldl, n, device, stream);
  if (n <= 16) return launch<16>(A, lda, L, ldl, n, device, stream);
  if (n <= 32) return launch<32>(A, lda, L, ldl, n, device, stream);
  if (n <= 64) return launch<64>(A, lda, L, ldl, n, device, stream);
  return launch<128>(A, lda, L, ldl, n, device, stream);
}

extern "C" const char* chol_tile_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The library's kernel functions for the resource query (tile.cuh's
// func_attrs): out[5] for function i, its name in *name.
extern "C" int chol_tile_func_attrs(int i, int device, int* out,
                                    const char** name) {
  static const FuncInfo fs[] = {
      {(const void*)chol_tile_kernel<8>, "chol_tile_kernel<8>",
       32 * Tile<8>::NW, Tile<8>::SMEM},
      {(const void*)chol_tile_kernel<16>, "chol_tile_kernel<16>",
       32 * Tile<16>::NW, Tile<16>::SMEM},
      {(const void*)chol_tile_kernel<32>, "chol_tile_kernel<32>",
       32 * Tile<32>::NW, Tile<32>::SMEM},
      {(const void*)chol_tile_kernel<64>, "chol_tile_kernel<64>",
       32 * Tile<64>::NW, Tile<64>::SMEM},
      {(const void*)chol_tile_kernel<128>, "chol_tile_kernel<128>",
       32 * Tile<128>::NW, Tile<128>::SMEM},
  };
  return func_attrs(fs, (int)(sizeof(fs) / sizeof(fs[0])), i, device, out,
                    name);
}
