// Fused batched supernode factorization for Hopper: POTRF + TRSM + SYRK over
// a stacked (Bp, Lp, Wp) group buffer, fp64.
//
// Replaces the TPU kernel src/repro/kernels/fused.py::fused_factor_syrk
// (body _fused_kernel, guard=False).  Semantics per lane b, with w = ws[b]
// and m = rows[b] - w:
//   * keep [0,w)x[0,w) (lower triangle) and [Wp,Wp+m)x[0,w), zero the rest,
//     ones on the diagonal for columns >= w, so pad cells may hold garbage;
//   * fp = the factored panel, strict upper triangle zero;
//   * u  = tril(T T^T) for the lane's true tail T = fp[Wp:Wp+m, :w], zeros
//     elsewhere; a pad lane (rows = w = 0) gives an identity fp and zero u.
//
// Design.  The TPU kernel keeps a whole lane (up to 2048 x 2048 fp64 =
// 33.5 MB here) resident in VMEM; a Hopper block has 227 KB of shared
// memory, so the lane stays in global memory (L2 holds 50 MB) and tiles are
// streamed through shared memory.  One CTA per lane would serialise the
// largest supernode on one SM, so each step is spread over many blocks:
//   1. mask pass over all cells (it also zeroes the slab counters);
//   2. per 64-column slab [k0, k1), two launches:
//        panel_kernel     blocks of 128 threads per lane, each taking one
//                         or more of the lane's 64-row tiles below the
//                         slab.  Every block loads the slab's diagonal
//                         block A11, factors it and inverts it in shared
//                         memory, then solves its row tiles as
//                         X = A21 L11^-T, a 64 x 64 x 64 product each on
//                         the fp64 tensor cores (mma.sync m16n8k8 f64,
//                         DMMA).  The 64^3/3 flops of the diagonal block
//                         are recomputed by every block, so there is no
//                         diagonal launch and no wait between blocks.  The
//                         factor is blocked in 8-wide sub-blocks: one warp
//                         factors an 8 x 8 diagonal sub-block in registers
//                         with shuffles (rsqrt of the pivot, no division)
//                         and inverts it; the block applies that inverse to
//                         the rows below and updates the trailing triangle,
//                         both as 16 x 8 DMMA fragments, while warp 0 looks
//                         ahead (it updates and factors the next diagonal
//                         sub-block first): 2 barriers per 8 columns (16
//                         per slab, where a column-serial sweep takes
//                         128).  L11^-1 is then built by recursive
//                         doubling from the 8 x 8
//                         inverses, inv([A 0; C B]) = [A^-1 0;
//                         -B^-1 C A^-1  B^-1], two block-wide products per
//                         level (6 barriers).  The explicit inverse of the
//                         64-wide diagonal block is what trsm_rlt.cu, the
//                         reference and MAGMA do; its error grows with
//                         cond(L11), which the card tests hold on a graded
//                         diagonal.  A wide lane gets a block per row tile;
//                         a group of many lanes gets fewer blocks per lane
//                         (one wave of the card's panel blocks in all, two
//                         per SM), so its diagonal blocks are not factored
//                         once per tile.  L11 itself is written back by the
//                         last block of the lane to finish reading A11 (a
//                         per-(slab, lane) atomic counter, zeroed by the
//                         mask pass): every other block has read A11 by
//                         then, so the write races with no read and no
//                         block waits for another;
//        trailing_kernel  one block per (lane, row tile, column tile on or
//                         below the diagonal) subtracts the slab's product
//                         from the trailing real columns, on the DMMA tile
//                         of tile.cuh (dmma_tile_nt);
//   3. syrk_kernel: one block per (lane, tile ti, tile tj <= ti) of U on the
//      DMMA tile, tiles at or past m skipped (u is zeroed by one memset).
// Lanes whose width w <= k0 exit at once, as pl.when(k0 < w) does on the
// TPU; row tiles with no live rows skip the solve, and trailing tiles with
// no live rows or wholly above the diagonal exit.  Nothing assumes Wp is a
// multiple of 64 (the last slab is narrower; the diagonal block is padded
// with the identity in shared memory) or that a lane starts 16-byte
// aligned (the tile picks 8- or 16-byte copies per operand).  All launches
// go on the caller's stream; the kernel allocates nothing (the wrapper
// passes the counters).  Launches per call: the mask pass, one memset,
// per slab the panel launch and, while real columns remain right of the
// slab, the trailing launch, then the SYRK: on lap3d_40's fused schedule
// 159 slabs, so at most 318 slab launches per factorization.
//
// Guarded variant (fused_factor_syrk_guarded_launch; replaces the same TPU
// kernel with guard=True, fused.py:84-198, :293-297, :332-343).  Per real
// column k the clamp rule needs theta, the largest below-diagonal |entry|
// of column k at its elimination over the lane's whole live height (rows
// (k, w) and the tail [Wp, Wp + m)), so the diagonal block can no longer be
// factored before the rows below it are up to date.  Instead one block per
// lane (guarded_slab_kernel, GNT threads) sweeps each 64-column slab over
// the full live height, column by column: reduce d^2 and theta, apply the
// clamp d2c = max(thr, |d2|, theta^2 GFLOOR_MULT / thr) (thr = 0: detect
// only), scale the column, then the rank-1 update of the slab's remaining
// real columns.  It takes the place of panel_kernel for the slab;
// trailing_kernel and syrk_kernel (on DMMA) are shared, so a guarded slab
// also costs 2 launches.  The status (min unclamped d^2, n clamped,
// nonfinite flag, clamp magnitude) lives in st (Bp, 4), initialised to
// (inf, 0, 0, 0) next to the mask pass and carried from slab to slab; the
// nonfinite flag is raised as each column's live cells are finalised.  NaN
// follows jnp: max propagates it (fmax would drop it), ~(d2 >= thr) holds
// for a NaN pivot, a nonfinite d2c falls back to thr.  One SM sweeps a
// whole lane, reading the slab through L2, so a wide lane is latency bound;
// a cooperative version that spreads a lane over many SMs is later work.
//
// Bound on this card: the work is O(w^3/3 + m w^2 + m^2 w) flops per lane
// against O(Lp Wp + (Lp-Wp)^2) bytes, far above the H100's ~20 flops/byte
// fp64 tensor-core balance for the large lanes, so the bound is flops at
// the fp64 tensor-core peak (67 TFLOP/s on the SXM part, 51 on PCIe), and
// bytes at 3.35 TB/s (2.0 on PCIe) for the small ones.  The trailing update
// and the SYRK, nearly all the flops, run on DMMA; the panel launch is
// latency bound (warp 0's serial chain of 64 pivots in 8-wide blocks:
// about 18 us a launch on the H100), and a wide lane's panel step runs
// on at most Lp / 64 blocks.  Left for later: TMA staging, a
// persistent kernel or a CUDA graph over the slab loop, and folding the
// mask pass into the first slab's loads.
//
#include <math_constants.h>

#include "tile.cuh"

namespace {

constexpr int NB = DT;        // slab width
constexpr int PNT = 128;      // threads of the panel kernel (4 warps)
constexpr int SB = 8;         // sub-block width of the diagonal factor
constexpr int NSB = NB / SB;  // sub-blocks per slab
constexpr int PLD = NB + 4;   // stride of the panel kernel's rows (4 mod 16)
constexpr int DS = SB + 4;    // stride of an 8 x 8 inverse (4 mod 16)
constexpr int PS = 32 + 4;    // stride of the doubling's products
constexpr int PSZ = 32 * PS;  // doubles of those products (>= NSB SB DS)
// L11, its inverse and a row tile (rows of PLD), the 8 x 8 inverses and
// then the doubling's products: 113,664 bytes, so two blocks fit an SM
constexpr int PANEL_SMEM = (3 * NB * PLD + PSZ) * (int)sizeof(double);

__global__ void mask_kernel(const double* __restrict__ in,
                            double* __restrict__ fp,
                            const int* __restrict__ rows,
                            const int* __restrict__ ws,
                            int* __restrict__ cnt, int ncnt, int Lp, int Wp,
                            long long total) {
  const long long per = (long long)Lp * Wp;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = first; idx < total; idx += step) {
    const int b = (int)(idx / per);
    const int rem = (int)(idx - (long long)b * per);
    const int r = rem / Wp, c = rem - r * Wp;
    const int w = ws[b], m = rows[b] - w;
    const bool keep =
        c < w && ((r < w && r >= c) || (r >= Wp && r < Wp + m));
    fp[idx] = keep ? in[idx] : ((r == c && r >= w) ? 1.0 : 0.0);
  }
  for (long long i = first; i < ncnt; i += step) cnt[i] = 0;
}

// Whether the 64-row tile [r0, r1) below a slab holds a live row: [k1, w)
// or the tail [Wp, Wp + m); the other rows are zero.
__device__ __forceinline__ bool tile_live(int r0, int r1, int w, int m,
                                          int Wp) {
  return r0 < w || (r0 < Wp + m && r1 > Wp);
}

// Blocks of the panel launch per lane: blockIdx.x takes the lane's 64-row
// tiles bx, bx + gridDim.x, ...  Each block factors and inverts the slab's
// diagonal block, then solves its tiles, X = A21 L11^-T on DMMA.  cnt
// counts this slab's blocks per lane; the last to count writes L11 back.
__global__ void __launch_bounds__(PNT)
    panel_kernel(double* __restrict__ fp, const int* __restrict__ rows,
                 const int* __restrict__ ws, int* __restrict__ cnt, int Lp,
                 int Wp, int k0, int nbk) {
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int w = ws[b];
  if (w <= k0) return;  // identity slab: nothing to factor
  const int m = rows[b] - w;
  const int k1 = k0 + nbk;
  const int nrt = (Lp - k1 + DT - 1) / DT;
  double* panel = fp + (size_t)b * Lp * Wp;
  int t0 = blockIdx.x;  // this block's first tile with a live row
  while (t0 < nrt && !tile_live(k1 + t0 * DT, min(k1 + (t0 + 1) * DT, Lp),
                                w, m, Wp))
    t0 += gridDim.x;
  __shared__ int last;
  if (t0 >= nrt) {  // no rows to solve: count, and go on only if last
    if (tid == 0) last = atomicAdd(cnt + b, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
  }
  extern __shared__ __align__(16) double sm[];
  double* L = sm;               // A11, factored in place into L11
  double* Li = L + NB * PLD;    // L11^-1
  double* X = Li + NB * PLD;    // a row tile of A21
  double* D = X + NB * PLD;     // inverses of the 8 x 8 diagonal blocks
  double* P = D;                // then the products of the doubling
  auto stage_tile = [&](int t) {
    const int r0 = k1 + t * DT;
    const double* A21 = panel + (size_t)r0 * Wp + k0;
    dmma_stage<NB, PLD, PNT>(X, A21, Wp, min(DT, Lp - r0), nbk, 0,
                        dmma_vec(A21, Wp));
    cp_async_commit();
  };
  {  // A11 (zero above the diagonal in fp), then this block's first tile
    const double* A11 = panel + (size_t)k0 * Wp + k0;
    dmma_stage<NB, PLD, PNT>(L, A11, Wp, nbk, nbk, 0, dmma_vec(A11, Wp));
    cp_async_commit();
  }
  if (t0 < nrt) stage_tile(t0);  // streams in while A11 is factored
  for (int e = tid; e < NB * NB; e += PNT) Li[(e / NB) * PLD + e % NB] = 0.0;
  if (t0 < nrt)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
  // pad a narrow slab's block to 64 x 64 with the identity
  for (int i = nbk + tid; i < NB; i += PNT) L[i * PLD + i] = 1.0;
  if (t0 < nrt && tid == 0) {  // A11 is read: count (read after barriers)
    __threadfence();
    last = atomicAdd(cnt + b, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  // Blocked right-looking Cholesky of L in 8-wide sub-blocks.  A pivot x
  // gives r = rsqrt(x), L[k][k] = x r and the column below scaled by r, so
  // the sweep has no division; a pivot <= 0 gives NaN, as sqrt does.
  // Warp 0 factors diagonal block J (serial in its 8 columns) and forms its
  // inverse DJ; look-ahead: it updates and factors block J + 1 while the
  // other warps do the rest of step J's trailing update.
  auto factor_diag = [&](int J) {
    const int j0 = J * SB;
    double* DJ = D + J * SB * DS;
    // lane i (mod 8) holds row j0 + i of the 8 x 8 diagonal sub-block
    const int i = lane & (SB - 1);
    double a[SB], rq[SB];
#pragma unroll
    for (int p = 0; p < SB; ++p) a[p] = L[(j0 + i) * PLD + j0 + p];
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const double x = __shfl_sync(0xffffffffu, a[q], q);
      rq[q] = rsqrt(x);
      a[q] = i == q ? x * rq[q] : (i > q ? a[q] * rq[q] : 0.0);
#pragma unroll
      for (int p = q + 1; p < SB; ++p) {
        const double lpq = __shfl_sync(0xffffffffu, a[q], p);
        if (i >= p) a[p] -= a[q] * lpq;
      }
    }
    // column c = i of DJ = L_JJ^-1 by forward substitution, with the rows
    // of L_JJ read from their lanes:
    //   x[r] = (d_rc - sum_{p<r} L[r][p] x[p]) / L[r][r]
    double x[SB];
#pragma unroll
    for (int r = 0; r < SB; ++r) {
      double s = r == i ? 1.0 : 0.0;
#pragma unroll
      for (int p = 0; p < r; ++p)
        s -= __shfl_sync(0xffffffffu, a[p], r) * x[p];
      x[r] = r < i ? 0.0 : s * rq[r];
    }
    if (lane < SB) {
#pragma unroll
      for (int p = 0; p < SB; ++p) {
        L[(j0 + i) * PLD + j0 + p] = a[p];
        DJ[p * DS + i] = x[p];
      }
    }
  };
  if (warp == 0) factor_diag(0);
  __syncthreads();
  for (int J = 0; J < NSB; ++J) {
    const int j0 = J * SB;
    // 16-row tiles (at multiples of 16) that hold rows >= j0 + 8
    const int lo = j0 + SB, mt0 = (lo / 16) * 16;
    const int nmt = (NB - mt0) / 16;
    // the rows below: L[r][j0 + c] = sum_p A[r][j0 + p] DJ[c][p], a warp
    // per 16-row tile (it reads and writes only its own rows)
    if (warp < nmt) {
      const int r0 = mt0 + 16 * warp;
      double a[4], bb[2], c[4] = {0.0, 0.0, 0.0, 0.0};
      frag_a(a, L, PLD, r0, j0);
      frag_bt(bb, D + J * SB * DS, DS, 0, 0);
      dmma(c, a, bb);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(r0, e);
        if (r >= lo) L[r * PLD + j0 + frag_col(0, e)] = c[e];
      }
    }
    __syncthreads();
    if (J + 1 == NSB) break;
    // the trailing lower triangle: L[r][c] -= sum_p L[r][j0 + p] L[c][j0 + p]
    // for lo <= c <= r, as 16 x 8 fragments (tasks); task 0 holds the next
    // diagonal block.  Two tasks at a time, so their loads overlap.
    const int nnt = (NB - lo) / SB, ntask = nmt * nnt;
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
        frag_a(a[h], L, PLD, r0[h], j0);
        frag_bt(bb[h], L, PLD, c0[h], j0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[h][e] = L[frag_row(r0[h], e) * PLD + frag_col(c0[h], e)];
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
          if (r >= lo && r >= cc) L[r * PLD + cc] = c[h][e];
        }
      }
    };
    if (warp == 0) {
      trail(0, ntask);
      __syncwarp();
      factor_diag(J + 1);
    } else {
      constexpr int OTHERS = PNT / 32 - 1;
      for (int t = warp; t < ntask; t += 2 * OTHERS) trail(t, t + OTHERS);
    }
    __syncthreads();
  }
  // L11^-1 by recursive doubling from the 8 x 8 inverses DJ: for each pair
  // of h-wide diagonal blocks with inverses A^-1, B^-1 and the block C
  // below A,  inv([A 0; C B]) = [A^-1 0; -B^-1 C A^-1  B^-1],  as the two
  // products P = C A^-1 and -B^-1 P on DMMA, every pair of a level at once.
  for (int e = tid; e < NSB * SB * SB; e += PNT) {
    const int J = e / (SB * SB), r = (e / SB) % SB, c = e % SB;
    Li[(J * SB + r) * PLD + J * SB + c] = D[J * SB * DS + r * DS + c];
  }
  __syncthreads();  // D is free: P overwrites it below
  {  // h = 8: a warp per pair (16-row fragments, the first 8 rows kept)
    const int base = 16 * warp;
    double a[4], bb[2], c[4] = {0.0, 0.0, 0.0, 0.0};
    frag_a(a, L, PLD, base + 8, base);
    frag_b(bb, Li, PLD, base, base);
    dmma(c, a, bb);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      P[(base / 2 + frag_row(0, e)) * PS + frag_col(0, e)] = c[e];
    __syncwarp();
    c[0] = c[1] = c[2] = c[3] = 0.0;
    frag_a(a, Li, PLD, base + 8, base + 8);
    frag_b(bb, P, PS, base / 2, 0);
    dmma(c, a, bb);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      Li[(base + 8 + frag_row(0, e)) * PLD + base + frag_col(0, e)] = -c[e];
  }
  __syncthreads();
  {  // h = 16: warp = (pair, 8-column half)
    const int base = 32 * (warp >> 1), q = warp & 1;
    double a[4], bb[2], c[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      frag_a(a, L, PLD, base + 16, base + 8 * s);
      frag_b(bb, Li, PLD, base + 8 * s, base + 8 * q);
      dmma(c, a, bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      P[(base / 2 + frag_row(0, e)) * PS + frag_col(8 * q, e)] = c[e];
    __syncthreads();
    c[0] = c[1] = c[2] = c[3] = 0.0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      frag_a(a, Li, PLD, base + 16, base + 16 + 8 * s);
      frag_b(bb, P, PS, base / 2 + 8 * s, 8 * q);
      dmma(c, a, bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Li[(base + 16 + frag_row(0, e)) * PLD + base + frag_col(8 * q, e)] =
          -c[e];
  }
  __syncthreads();
  {  // h = 32: warp = (16-row tile, two 8-column tiles)
    const int mi = warp >> 1, nj = 2 * (warp & 1);
    double a[4], bb[2], c[2][4] = {};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      frag_a(a, L, PLD, 32 + 16 * mi, 8 * s);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        frag_b(bb, Li, PLD, 8 * s, 8 * (nj + j));
        dmma(c[j], a, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        P[frag_row(16 * mi, e) * PS + frag_col(8 * (nj + j), e)] = c[j][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      frag_a(a, Li, PLD, 32 + 16 * mi, 32 + 8 * s);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        frag_b(bb, P, PS, 8 * s, 8 * (nj + j));
        dmma(c[j], a, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Li[(32 + frag_row(16 * mi, e)) * PLD + frag_col(8 * (nj + j), e)] =
            -c[j][e];
  }
  // X = A21 Li^T, tile by tile: acc[r][c] = sum_k X[r][k] Li[c][k]
  for (int t = t0; t < nrt; t += gridDim.x) {
    const int r0 = k1 + t * DT, r1 = min(r0 + DT, Lp);
    if (t != t0) {
      if (!tile_live(r0, r1, w, m, Wp)) continue;
      stage_tile(t);
    }
    cp_async_wait<0>();
    __syncthreads();
    double acc[2][4][4] = {};
    dmma_smem<4>(X, PLD, Li, PLD, NB, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + dmma_row<4>(i, e), c = dmma_col<4>(j, e);
          if (r < r1 && c < nbk)
            panel[(size_t)r * Wp + k0 + c] = acc[i][j][e];
        }
    __syncthreads();  // X is restaged for the next tile
  }
  if (last) {
    __syncthreads();
    for (int e = tid; e < nbk * nbk; e += PNT) {
      const int i = e / nbk, p = e % nbk;
      panel[(size_t)(k0 + i) * Wp + k0 + p] = p <= i ? L[i * PLD + p] : 0.0;
    }
  }
}

__global__ void __launch_bounds__(DNT)
    trailing_kernel(double* __restrict__ fp, const int* __restrict__ rows,
                    const int* __restrict__ ws, int Lp, int Wp, int k0,
                    int nbk, int nct) {
  const int b = blockIdx.y;
  const int w = ws[b];
  const int k1 = k0 + nbk;
  if (w <= k1) return;  // no real column right of the slab
  const int m = rows[b] - w;
  const int ct = blockIdx.x % nct, rt = blockIdx.x / nct;
  const int c0 = k1 + ct * DT, r0 = k1 + rt * DT;
  if (c0 >= w) return;          // identity columns receive no update
  if (r0 + DT <= c0) return;    // tile wholly above the diagonal
  const int r1 = min(r0 + DT, Lp);
  if (!(r0 < w || (r0 < Wp + m && r1 > Wp))) return;
  extern __shared__ __align__(16) double sm[];
  double acc[2][16 / DNW][4] = {};
  double* panel = fp + (size_t)b * Lp * Wp;
  dmma_tile_nt(panel + (size_t)r0 * Wp + k0, Wp, r1 - r0,
               panel + (size_t)c0 * Wp + k0, Wp, min(DT, Wp - c0), nbk, acc,
               sm);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16 / DNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + dmma_row<DNW>(i, e), c = c0 + dmma_col<DNW>(j, e);
        if (r < Lp && c < Wp && r >= c)
          panel[(size_t)r * Wp + c] -= acc[i][j][e];
      }
}

__global__ void __launch_bounds__(DNT)
    syrk_kernel(const double* __restrict__ fp, double* __restrict__ u,
                const int* __restrict__ rows, const int* __restrict__ ws,
                int Lp, int Wp, int nt) {
  const int b = blockIdx.y;
  const int w = ws[b], m = rows[b] - w, mp = Lp - Wp;
  const int rt = blockIdx.x / nt, ct = blockIdx.x % nt;
  if (ct > rt) return;
  const int r0 = rt * DT, c0 = ct * DT;
  if (r0 >= m) return;  // c0 <= r0, so the whole tile is past the tail
  extern __shared__ __align__(16) double sm[];
  double acc[2][16 / DNW][4] = {};
  const double* T = fp + (size_t)b * Lp * Wp + (size_t)Wp * Wp;
  // columns >= w of the tail are zero: the product stops at w
  dmma_tile_nt(T + (size_t)r0 * Wp, Wp, min(DT, m - r0), T + (size_t)c0 * Wp,
               Wp, min(DT, m - c0), w, acc, sm);
  double* ub = u + (size_t)b * mp * mp;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16 / DNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + dmma_row<DNW>(i, e), c = c0 + dmma_col<DNW>(j, e);
        if (r < m && c < m && r >= c) ub[(size_t)r * mp + c] = acc[i][j][e];
      }
}

// ---------------------------------------------------------------------------
// guarded variant
// ---------------------------------------------------------------------------
constexpr int GNT = 512;  // threads of the guarded sweep (one block a lane)

// NaN-propagating max, as jnp.max / jnp.maximum (fmax drops NaN)
__device__ __forceinline__ double nan_max(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void status_init_kernel(double* __restrict__ st, int Bp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < Bp) {
    st[4 * b + 0] = CUDART_INF;
    st[4 * b + 1] = 0.0;
    st[4 * b + 2] = 0.0;
    st[4 * b + 3] = 0.0;
  }
}

// Row of the i-th live row strictly below column k: [k+1, w), then the
// tail [Wp, Wp + m).
__device__ __forceinline__ int live_row(int i, int nd, int k, int Wp) {
  return i < nd ? k + 1 + i : Wp + (i - nd);
}

__global__ void guarded_slab_kernel(double* __restrict__ fp,
                                    const int* __restrict__ rows,
                                    const int* __restrict__ ws,
                                    double* __restrict__ st, int Lp, int Wp,
                                    int k0, int nbk, double thr, double gf) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int w = ws[b];
  if (w <= k0) return;  // identity slab: nothing to factor, no status
  const int m = min(rows[b] - w, Lp - Wp);  // tail rows stop at Lp
  const int k1 = min(k0 + nbk, w);  // the slab's real columns
  double* panel = fp + (size_t)b * Lp * Wp;
  double* s = st + 4 * b;
  __shared__ double red[GNT / 32];
  __shared__ double colk[NB];  // scaled column k at rows (k, k1)
  __shared__ double sh_dk;
  double mind2 = s[0], ncl = s[1], mag = s[3];  // thread 0's copy is used
  int bad = 0;
  const double tmax = thr > 1e-300 ? thr : 1e-300;
  for (int k = k0; k < k1; ++k) {
    __syncthreads();  // column k is up to date
    const int nd = w - k - 1;
    const int nlive = nd + m;
    // theta = max |a_rk| over the live rows below k, NaN-propagating
    double t = 0.0;
    for (int i = tid; i < nlive; i += GNT)
      t = nan_max(t, fabs(panel[(size_t)live_row(i, nd, k, Wp) * Wp + k]));
    for (int off = 16; off > 0; off >>= 1)
      t = nan_max(t, __shfl_xor_sync(0xffffffffu, t, off));
    if ((tid & 31) == 0) red[tid >> 5] = t;
    __syncthreads();
    if (tid == 0) {
      double theta = red[0];
      for (int j = 1; j < GNT / 32; ++j) theta = nan_max(theta, red[j]);
      double d2 = panel[(size_t)k * Wp + k];
      if (d2 < mind2) mind2 = d2;  // NaN-ignoring: a NaN pivot never wins
      const double gfloor = theta * theta * (gf / tmax);
      const bool cl = thr > 0.0 && (!(d2 >= thr) || !(d2 >= gfloor));
      if (cl) {
        double d2c = nan_max(nan_max(thr, fabs(d2)), gfloor);
        if (!isfinite(d2c)) d2c = thr;
        ncl += 1.0;
        mag += isfinite(d2) ? d2c - d2 : d2c;
        d2 = d2c;
      }
      const double dk = sqrt(d2);
      panel[(size_t)k * Wp + k] = dk;
      sh_dk = dk;
      if (!isfinite(dk)) bad = 1;
    }
    __syncthreads();
    const double dk = sh_dk;
    for (int i = tid; i < nlive; i += GNT) {
      const int r = live_row(i, nd, k, Wp);
      const double v = panel[(size_t)r * Wp + k] / dk;
      panel[(size_t)r * Wp + k] = v;
      if (!isfinite(v)) bad = 1;
      if (i < k1 - k - 1) colk[i] = v;
    }
    __syncthreads();
    // rank-1 update of the slab's real columns j in (k, k1), lower cells
    const int nj = k1 - k - 1;
    if (nj > 0) {
      for (int e = tid; e < nlive * nj; e += GNT) {
        const int i = e / nj, jj = e - (e / nj) * nj;
        const int r = live_row(i, nd, k, Wp);
        const int j = k + 1 + jj;
        if (r >= j)
          panel[(size_t)r * Wp + j] -= panel[(size_t)r * Wp + k] * colk[jj];
      }
    }
  }
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    s[0] = mind2;
    s[1] = ncl;
    if (bad) s[2] = 1.0;
    s[3] = mag;
  }
}

}  // namespace

// Allow the kernels' dynamic shared memory (above the 48 KB default), once
// per device, and read its SM count.
static cudaError_t prepare(int device, int* sms) {
  static int known[64];
  if (device >= 0 && device < 64 && known[device] > 0) {
    *sms = known[device];
    return cudaSuccess;
  }
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(panel_kernel, attr, PANEL_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(trailing_kernel, attr, DMMA_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(syrk_kernel, attr, DMMA_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < 64) known[device] = *sms;
  return err;
}

// Blocks per lane of a panel launch over nrt row tiles: one per tile (the
// most parallel), but no more than one wave of the card's panel blocks in
// all (two per SM fit its shared memory), so a group of many lanes
// factors each diagonal block once or a few times, not once per tile.  At
// least one, which writes L11 when no row lies below the slab.
static int panel_blocks(int nrt, int Bp, int sms) {
  const int wave = 2 * sms / Bp;
  return nrt < 1 ? 1 : (nrt < wave ? nrt : (wave > 1 ? wave : 1));
}

// Blocks of the grid-stride mask pass over total cells.
static int mask_blocks(long long total) {
  const long long want = (total + NT - 1) / NT;
  return (int)(want < 132LL * 32 ? (want > 0 ? want : 1) : 132LL * 32);
}

// panels, fp: (Bp, Lp, Wp) fp64; u: (Bp, Lp-Wp, Lp-Wp) fp64 (may be null
// when Lp == Wp); rows, ws: (Bp,) int32; cnt: (ceil(Wp / min(Wp, 64)) * Bp)
// int32 scratch, the panel launches' per-(slab, lane) counters.  Returns a
// cudaError_t code.
extern "C" int fused_factor_syrk_launch(const double* panels, const int* rows,
                                        const int* ws, double* fp, double* u,
                                        int* cnt, int Bp, int Lp, int Wp,
                                        int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  int sms = 0;
  CHECK(prepare(device, &sms));
  const int nb = Wp < NB ? Wp : NB;
  const int nslab = (Wp + nb - 1) / nb;
  const long long total = (long long)Bp * Lp * Wp;
  mask_kernel<<<mask_blocks(total), NT, 0, stream>>>(
      panels, fp, rows, ws, cnt, nslab * Bp, Lp, Wp, total);
  CHECK(cudaGetLastError());
  const int mp = Lp - Wp;
  if (mp > 0)
    CHECK(cudaMemsetAsync(u, 0, sizeof(double) * (size_t)Bp * mp * mp,
                          stream));
  for (int s = 0; s < nslab; ++s) {
    const int k0 = s * nb;
    const int nbk = nb < Wp - k0 ? nb : Wp - k0;
    const int k1 = k0 + nbk;
    const int nrt = (Lp - k1 + DT - 1) / DT;
    panel_kernel<<<dim3(panel_blocks(nrt, Bp, sms), Bp), PNT, PANEL_SMEM,
                   stream>>>(fp, rows, ws, cnt + (size_t)s * Bp, Lp, Wp, k0,
                             nbk);
    CHECK(cudaGetLastError());
    const int nct = (Wp - k1 + DT - 1) / DT;
    if (nct > 0) {
      trailing_kernel<<<dim3(nrt * nct, Bp), DNT, DMMA_SMEM_BYTES,
                        stream>>>(
          fp, rows, ws, Lp, Wp, k0, nbk, nct);
      CHECK(cudaGetLastError());
    }
  }
  if (mp > 0) {
    const int nt = (mp + DT - 1) / DT;
    syrk_kernel<<<dim3(nt * nt, Bp), DNT, DMMA_SMEM_BYTES, stream>>>(
        fp, u, rows, ws, Lp, Wp, nt);
    CHECK(cudaGetLastError());
  }
  return 0;
}

// As fused_factor_syrk_launch, plus st: (Bp, 4) fp64 per-lane status, and
// the clamp threshold thr (0: detect only) with gf = GFLOOR_MULT.
extern "C" int fused_factor_syrk_guarded_launch(
    const double* panels, const int* rows, const int* ws, double* fp,
    double* u, double* st, int Bp, int Lp, int Wp, double thr, double gf,
    int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  int sms = 0;
  CHECK(prepare(device, &sms));
  const long long total = (long long)Bp * Lp * Wp;
  mask_kernel<<<mask_blocks(total), NT, 0, stream>>>(panels, fp, rows, ws,
                                                     nullptr, 0, Lp, Wp,
                                                     total);
  CHECK(cudaGetLastError());
  status_init_kernel<<<(Bp + NT - 1) / NT, NT, 0, stream>>>(st, Bp);
  CHECK(cudaGetLastError());
  const int mp = Lp - Wp;
  if (mp > 0)
    CHECK(cudaMemsetAsync(u, 0, sizeof(double) * (size_t)Bp * mp * mp,
                          stream));
  const int nb = Wp < NB ? Wp : NB;
  for (int k0 = 0; k0 < Wp; k0 += nb) {
    const int nbk = nb < Wp - k0 ? nb : Wp - k0;
    const int k1 = k0 + nbk;
    guarded_slab_kernel<<<Bp, GNT, 0, stream>>>(fp, rows, ws, st, Lp, Wp, k0,
                                                nbk, thr, gf);
    CHECK(cudaGetLastError());
    const int nrt = (Lp - k1 + DT - 1) / DT;
    const int nct = (Wp - k1 + DT - 1) / DT;
    if (nct > 0) {
      trailing_kernel<<<dim3(nrt * nct, Bp), DNT, DMMA_SMEM_BYTES,
                        stream>>>(
          fp, rows, ws, Lp, Wp, k0, nbk, nct);
      CHECK(cudaGetLastError());
    }
  }
  if (mp > 0) {
    const int nt = (mp + DT - 1) / DT;
    syrk_kernel<<<dim3(nt * nt, Bp), DNT, DMMA_SMEM_BYTES, stream>>>(
        fp, u, rows, ws, Lp, Wp, nt);
    CHECK(cudaGetLastError());
  }
  return 0;
}

extern "C" const char* fused_factor_syrk_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
