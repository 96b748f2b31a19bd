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
//                         level (6 barriers; tile.cuh's tri_inv64_doubling,
//                         shared with tri_inv.cu and trsm_rlt.cu).  The
//                         explicit inverse of the
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
// aligned (the tile picks 8- or 16-byte copies per operand).  Lanes sit
// lane-major on gridDim.x (block t of lane b is b * per + t), which takes
// 2^31 - 1 blocks where gridDim.y took 65,535 lanes, so cholesky_many may
// stack any number of matrices into one call.  All launches
// go on the caller's stream; the kernel allocates nothing (the wrapper
// passes the counters).  Launches per call: the mask pass, one memset,
// per slab the panel launch and, while real columns remain right of the
// slab, the trailing launch, then the SYRK: on lap3d_40's fused schedule
// 159 slabs, so at most 318 slab launches per factorization.
//
// Guarded variant (fused_factor_syrk_guarded_launch; replaces the same TPU
// kernel with guard=True, fused.py:84-198, :293-297, :332-343).  The
// reference sweeps column by column: per real column k, with d2 its pivot
// and theta the largest below-diagonal |entry| at its elimination over
// the lane's live height (rows (k, w) and the tail [Wp, Wp + m)), it
// clamps d2c = max(thr, |d2|, theta^2 GFLOOR_MULT / thr) when thr > 0 and
// d2 < thr or d2 < theta^2 GFLOOR_MULT / thr, and keeps the status (min
// unclamped d^2 NaN-ignoring, n clamped, nonfinite flag, clamp magnitude).
// Without a clamp the sweep is the unguarded factor, and theta_k is
// sqrt(x_k) max |L[r][k]| over the rows below k of the unclamped blocked
// factor.  So each slab runs speculatively, is checked, and is repaired
// only where needed:
//   1. panel_kernel<true>: the unguarded panel launch (the blocked DMMA
//      factor, unclamped), which also keeps the slab's cells as they were
//      (A11 and the staged row tiles, into cpy), the pivots x before their
//      rsqrt (tile.cuh's chol8_rsqrt with its pivot out) and per column the
//      largest |L[r][k]| below the diagonal, folded across blocks with
//      atomicMax on the bits of |value| (order independent, so
//      deterministic; NaN ranks above inf, as nan_max propagates it);
//   2. guarded_slab_kernel: one block per lane checks the slab's real
//      columns (every x and theta finite, x > 0, and x above thr and the
//      growth floor by a relative margin of 1e-8 plus an absolute slack
//      that bounds the two orders' rounding gap over a slab).  A lane that
//      passes is one the sweep would not clamp, and whose slab is finite:
//      it folds its pivots into min d^2 and exits.  Any other lane (one
//      that clamps, a nonpositive or nonfinite pivot, a NaN) is routed: it
//      restores what the panel launch wrote and sweeps the slab column by
//      column over its full live height, as the reference does, updating
//      the status.  So clamp counts and flags are the sweep's, at thr = 0
//      too (a zero pivot gives 0 through sqrt and NaN through rsqrt);
//   3. the trailing launch, shared with the unguarded kernel.
// The status starts at (inf, 0, 0, 0) in guard_init_kernel (which also
// zeroes the column maxima), beside the mask pass.  Launches: the mask
// pass, the init, per slab the panel, the check and (while real columns
// remain right of the slab) the trailing launch, then the SYRK, at any
// thr.  A lane that never routes costs row 1's work plus the copy (one
// store of each staged cell) and a check that exits; a routed slab costs
// the sweep: one SM per lane, reading the slab through L2, latency bound
// on a wide lane.  Spreading a routed wide lane over many SMs is later
// work.
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
constexpr int ENT = 256;      // threads of the mask pass and the status init
constexpr int PNT = 128;      // threads of the panel kernel (4 warps)
constexpr int SB = 8;         // sub-block width of the diagonal factor
constexpr int NSB = NB / SB;  // sub-blocks per slab
constexpr int PLD = TLD;      // stride of the panel kernel's rows (4 mod 16)
constexpr int DS = SB + 4;    // stride of an 8 x 8 inverse (4 mod 16)
constexpr int PSZ = TPSZ;     // doubles of the doubling's products
static_assert(PSZ >= NSB * SB * DS, "the 8 x 8 inverses share P");
// L11, its inverse and a row tile (rows of PLD), the 8 x 8 inverses and
// then the doubling's products: 113,664 bytes, so two blocks fit an SM
constexpr int PANEL_SMEM = (3 * NB * PLD + PSZ) * (int)sizeof(double);
// the guarded instantiation adds the block's column maxima (64 x 8 bytes)
constexpr int PANEL_SMEM_G = PANEL_SMEM + NB * (int)sizeof(double);

// The guarded panel launch's scratch for one slab (the wrapper allocates
// it; unused by the unguarded instantiation): per lane and slab column
// the pivot x before its rsqrt and the largest |L[r][k]| below the
// diagonal (as the bits of |value|, so atomicMax orders them, NaN above
// inf), and the slab's columns of every row the launch reads, as they
// were before it (row r of lane b at cpy[(b Lp + r) nb]).
struct GuardSlab {
  double* piv;
  unsigned long long* thm;
  double* cpy;
  int nb;
};

// |v| as ordered bits: the unsigned order of the bits of a nonnegative
// double is its numeric order, with NaN above inf
__device__ __forceinline__ unsigned long long abs_bits(double v) {
  return (unsigned long long)__double_as_longlong(v) & 0x7fffffffffffffffULL;
}
__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

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

// Blocks of the panel launch: nbl per lane, lane-major on gridDim.x (block
// bx of lane b is blockIdx.x = b nbl + bx), so any number of lanes
// launches.  Block bx takes the lane's 64-row tiles bx, bx + nbl, ...  Each
// block factors and inverts the slab's diagonal block, then solves its
// tiles, X = A21 L11^-T on DMMA.  cnt counts this slab's blocks per lane;
// the last to count writes L11 back.  The guarded instantiation (G) also
// keeps the slab as it was in g.cpy (each block its staged row tiles, the
// last block A11, from shared memory before factoring it), the last block
// writes the pivots to g.piv, and every block folds max |L[r][k]| over its
// rows below k into g.thm.
template <bool G>
__global__ void __launch_bounds__(PNT)
    panel_kernel(double* __restrict__ fp, const int* __restrict__ rows,
                 const int* __restrict__ ws, int* __restrict__ cnt, int Lp,
                 int Wp, int k0, int nbk, int nbl, GuardSlab g) {
  const int b = blockIdx.x / nbl, bx = blockIdx.x - b * nbl;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int w = ws[b];
  if (w <= k0) return;  // identity slab: nothing to factor
  const int m = rows[b] - w;
  const int k1 = k0 + nbk;
  const int nrt = (Lp - k1 + DT - 1) / DT;
  double* panel = fp + (size_t)b * Lp * Wp;
  int t0 = bx;  // this block's first tile with a live row
  while (t0 < nrt && !tile_live(k1 + t0 * DT, min(k1 + (t0 + 1) * DT, Lp),
                                w, m, Wp))
    t0 += nbl;
  __shared__ int last;
  if (t0 >= nrt) {  // no rows to solve: count, and go on only if last
    if (tid == 0) last = atomicAdd(cnt + b, 1) == nbl - 1;
    __syncthreads();
    if (!last) return;
  }
  extern __shared__ __align__(16) double sm[];
  double* L = sm;               // A11, factored in place into L11
  double* Li = L + NB * PLD;    // L11^-1
  double* X = Li + NB * PLD;    // a row tile of A21
  double* D = X + NB * PLD;     // inverses of the 8 x 8 diagonal blocks
  double* P = D;                // then the products of the doubling
  // G: the block's max |L[r][k]| per slab column, as bits
  unsigned long long* cmax = (unsigned long long*)(P + PSZ);
  if constexpr (G)
    for (int c = tid; c < NB; c += PNT) cmax[c] = 0ULL;
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
    last = atomicAdd(cnt + b, 1) == nbl - 1;
  }
  __syncthreads();
  if constexpr (G) {
    if (last) {  // A11 as it was, for the sweep to restore
      for (int e = tid; e < nbk * nbk; e += PNT) {
        const int i = e / nbk, p = e - i * nbk;
        g.cpy[((size_t)b * Lp + k0 + i) * g.nb + p] = L[i * PLD + p];
      }
      __syncthreads();
    }
  }
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
    if constexpr (G) {
      double xi;
      chol8_rsqrt(a, rq, i, xi);
      if (last && lane < SB && j0 + lane < nbk)
        g.piv[(size_t)b * g.nb + j0 + lane] = xi;
    } else {
      chol8_rsqrt(a, rq, i);
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
  // L11^-1 by recursive doubling from the 8 x 8 inverses DJ, placed on
  // Li's diagonal (tile.cuh: tri_inv64_doubling)
  for (int e = tid; e < NSB * SB * SB; e += PNT) {
    const int J = e / (SB * SB), r = (e / SB) % SB, c = e % SB;
    Li[(J * SB + r) * PLD + J * SB + c] = D[J * SB * DS + r * DS + c];
  }
  __syncthreads();  // D is free: P overwrites it below
  tri_inv64_doubling(L, Li, P);
  // X = A21 Li^T, tile by tile: acc[r][c] = sum_k X[r][k] Li[c][k]
  for (int t = t0; t < nrt; t += nbl) {
    const int r0 = k1 + t * DT, r1 = min(r0 + DT, Lp);
    if (t != t0) {
      if (!tile_live(r0, r1, w, m, Wp)) continue;
      stage_tile(t);
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (G)  // the tile as it was, for the sweep to restore
      for (int e = tid; e < (r1 - r0) * nbk; e += PNT) {
        const int rr = e / nbk, c = e - rr * nbk;
        g.cpy[((size_t)b * Lp + r0 + rr) * g.nb + c] = X[rr * PLD + c];
      }
    double acc[2][4][4] = {};
    dmma_smem<4>(X, PLD, Li, PLD, NB, acc);
    unsigned long long mx[4][2] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + dmma_row<4>(i, e), c = dmma_col<4>(j, e);
          if (r < r1 && c < nbk) {
            panel[(size_t)r * Wp + k0 + c] = acc[i][j][e];
            if constexpr (G)
              mx[j][e & 1] = umax64(mx[j][e & 1], abs_bits(acc[i][j][e]));
          }
        }
    if constexpr (G) {
      // the lanes of one t = lane % 4 hold the same 8 columns: reduce over
      // g = lane / 4, then one lane per column folds it into cmax
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mx[j][h] = umax64(mx[j][h],
                              __shfl_xor_sync(0xffffffffu, mx[j][h], off));
          if (lane < 4 && mx[j][h]) atomicMax(cmax + dmma_col<4>(j, h),
                                              mx[j][h]);
        }
    }
    __syncthreads();  // X is restaged for the next tile
  }
  if (last) {
    __syncthreads();
    for (int e = tid; e < nbk * nbk; e += PNT) {
      const int i = e / nbk, p = e % nbk;
      panel[(size_t)(k0 + i) * Wp + k0 + p] = p <= i ? L[i * PLD + p] : 0.0;
    }
    if constexpr (G) {  // L11's column maxima: two threads a column
      const int p = tid & (NB - 1);
      unsigned long long m = 0ULL;
      for (int i = p + 1 + tid / NB; i < nbk; i += PNT / NB)
        m = umax64(m, abs_bits(L[i * PLD + p]));
      if (m) atomicMax(cmax + p, m);
    }
  }
  if constexpr (G) {
    __syncthreads();
    for (int c = tid; c < nbk; c += PNT)
      if (cmax[c]) atomicMax(g.thm + (size_t)b * g.nb + c, cmax[c]);
  }
}

__global__ void __launch_bounds__(DNT)
    trailing_kernel(double* __restrict__ fp, const int* __restrict__ rows,
                    const int* __restrict__ ws, int Lp, int Wp, int k0,
                    int nbk, int nrt, int nct) {
  // nrt x nct tiles per lane, lane-major on gridDim.x
  const int b = blockIdx.x / (nrt * nct), t = blockIdx.x - b * (nrt * nct);
  const int w = ws[b];
  const int k1 = k0 + nbk;
  if (w <= k1) return;  // no real column right of the slab
  const int m = rows[b] - w;
  const int ct = t % nct, rt = t / nct;
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
  // nt x nt tiles per lane, lane-major on gridDim.x
  const int b = blockIdx.x / (nt * nt), t = blockIdx.x - b * (nt * nt);
  const int w = ws[b], m = rows[b] - w, mp = Lp - Wp;
  const int rt = t / nt, ct = t % nt;
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
// The check's margins: a pivot x passes only ROUTE_DELTA (relative) above
// thr and above the growth floor, plus ROUTE_SLACK (|pre| + |x|), pre the
// column's diagonal before the slab.  The slack bounds the rounding gap
// between the blocked factor's x and the column sweep's: each sums at most
// NB products, within about NB eps (|pre| + s) of exact, s the slab's sum
// of squares of the row, and s <= |pre| + |x|.  Both are far below any
// clamp that matters.
constexpr double ROUTE_DELTA = 1e-8;
constexpr double ROUTE_SLACK = 4.0 * NB * 2.220446049250313e-16;

// NaN-propagating max, as jnp.max / jnp.maximum (fmax drops NaN)
__device__ __forceinline__ double nan_max(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// The status (inf, 0, 0, 0) of every lane, and the zeroed column maxima of
// every slab.
__global__ void guard_init_kernel(double* __restrict__ st, int Bp,
                                  unsigned long long* __restrict__ thm,
                                  long long nthm) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long b = first; b < Bp; b += step) {
    st[4 * b + 0] = CUDART_INF;
    st[4 * b + 1] = 0.0;
    st[4 * b + 2] = 0.0;
    st[4 * b + 3] = 0.0;
  }
  for (long long i = first; i < nthm; i += step) thm[i] = 0ULL;
}

// Row of the i-th live row strictly below column k: [k+1, w), then the
// tail [Wp, Wp + m).
__device__ __forceinline__ int live_row(int i, int nd, int k, int Wp) {
  return i < nd ? k + 1 + i : Wp + (i - nd);
}

// One block per lane, after the slab's guarded panel launch.  The check:
// warp 0 reads the slab's real columns' pivots x and maxima, theta = sqrt(x)
// max |L[r][k]| (the column's largest unscaled entry below the diagonal),
// and passes the lane when every x and theta is finite, x > 0, and x clears
// thr and the growth floor theta^2 gf / thr by the margins above (at thr =
// 0 only the slack): then the column sweep would clamp nothing either, and
// the speculative factor stands; the lane folds its pivots into min d^2 and
// exits (every value it wrote is finite).  Otherwise the lane is routed:
// its panel counter is set to -1 (the wrapper's record of the sweeps), the
// cells the panel launch wrote are restored from g.cpy (A11 and every row
// tile with a live row, all nbk columns, so a pad cell the speculative
// factor made NaN is undone too), and the slab is swept column by column
// over the full live height: reduce d^2 and theta, clamp d2c = max(thr,
// |d2|, theta^2 gf / thr) (thr = 0: detect only), scale the column, then
// the rank-1 update of the slab's remaining real columns.
__global__ void __launch_bounds__(GNT)
    guarded_slab_kernel(double* __restrict__ fp, const int* __restrict__ rows,
                        const int* __restrict__ ws, double* __restrict__ st,
                        int* __restrict__ cnt, GuardSlab g, int Lp, int Wp,
                        int k0, int nbk, double thr, double gf) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int w = ws[b];
  if (w <= k0) return;  // identity slab: nothing to factor, no status
  const int k1 = min(k0 + nbk, w);  // the slab's real columns
  double* panel = fp + (size_t)b * Lp * Wp;
  double* s = st + 4 * b;
  const double* piv = g.piv + (size_t)b * g.nb;
  const double* cpy = g.cpy + (size_t)b * Lp * g.nb;
  __shared__ int route;
  if (tid < 32) {
    bool bad = false;
    for (int k = k0 + tid; k < k1; k += 32) {
      const double x = piv[k - k0];
      const double theta =
          sqrt(x) * __longlong_as_double(
                        (long long)g.thm[(size_t)b * g.nb + k - k0]);
      const double pre = cpy[(size_t)k * g.nb + k - k0];
      const double slack = ROUTE_SLACK * (fabs(pre) + fabs(x));
      bool ok = isfinite(x) && isfinite(theta) && x > 0.0 &&
                x >= thr * (1.0 + ROUTE_DELTA) + slack;
      if (thr > 0.0)
        ok = ok &&
             x >= theta * theta * (gf / thr) * (1.0 + ROUTE_DELTA) + slack;
      bad = bad || !ok;
    }
    bad = __any_sync(0xffffffffu, bad);
    if (tid == 0) route = bad;
  }
  __syncthreads();
  if (!route) {  // the speculative factor stands
    if (tid == 0) {
      double mind2 = s[0];
      for (int k = k0; k < k1; ++k)
        if (piv[k - k0] < mind2) mind2 = piv[k - k0];
      s[0] = mind2;
    }
    return;
  }
  if (tid == 0) cnt[b] = -1;
  {  // restore what the panel launch wrote: A11 and the live row tiles
    const int kp = k0 + nbk, mf = rows[b] - w;
    for (int e = tid; e < (Lp - k0) * nbk; e += GNT) {
      const int r = k0 + e / nbk, c = e - (e / nbk) * nbk;
      if (r >= kp) {
        const int r0 = kp + (r - kp) / DT * DT;
        if (!tile_live(r0, min(r0 + DT, Lp), w, mf, Wp)) continue;
      }
      panel[(size_t)r * Wp + k0 + c] = cpy[(size_t)r * g.nb + c];
    }
  }
  const int m = min(rows[b] - w, Lp - Wp);  // tail rows stop at Lp
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
  cudaError_t err = cudaFuncSetAttribute(panel_kernel<false>, attr,
                                         PANEL_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(panel_kernel<true>, attr, PANEL_SMEM_G);
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

// A grid of per blocks for each of Bp lanes, lane-major on gridDim.x: it
// must fit the x dimension (2^31 - 1 blocks).
static cudaError_t lane_grid(long long per, int Bp) {
  return per * Bp <= 0x7fffffffLL ? cudaSuccess
                                  : cudaErrorInvalidConfiguration;
}

// The trailing launch of the slab [k0, k0 + nbk), while real columns
// remain right of it.
static cudaError_t trailing(double* fp, const int* rows, const int* ws,
                            int Bp, int Lp, int Wp, int k0, int nbk,
                            cudaStream_t stream) {
  const int k1 = k0 + nbk;
  const int nrt = (Lp - k1 + DT - 1) / DT;
  const int nct = (Wp - k1 + DT - 1) / DT;
  if (nct <= 0) return cudaSuccess;
  cudaError_t err = lane_grid((long long)nrt * nct, Bp);
  if (err != cudaSuccess) return err;
  trailing_kernel<<<nrt * nct * Bp, DNT, DMMA_SMEM_BYTES, stream>>>(
      fp, rows, ws, Lp, Wp, k0, nbk, nrt, nct);
  return cudaGetLastError();
}

// The SYRK launch, when Lp > Wp.
static cudaError_t syrk(const double* fp, double* u, const int* rows,
                        const int* ws, int Bp, int Lp, int Wp,
                        cudaStream_t stream) {
  const int mp = Lp - Wp;
  if (mp <= 0) return cudaSuccess;
  const int nt = (mp + DT - 1) / DT;
  cudaError_t err = lane_grid((long long)nt * nt, Bp);
  if (err != cudaSuccess) return err;
  syrk_kernel<<<nt * nt * Bp, DNT, DMMA_SMEM_BYTES, stream>>>(
      fp, u, rows, ws, Lp, Wp, nt);
  return cudaGetLastError();
}

// Blocks of the grid-stride mask pass over total cells.
static int mask_blocks(long long total) {
  const long long want = (total + ENT - 1) / ENT;
  return (int)(want < 132LL * 32 ? (want > 0 ? want : 1) : 132LL * 32);
}

// The slab loop of both entry points.  G: the guarded route, with the
// status st, thr, gf and the scratch gs and cpy (see the guarded entry).
template <bool G>
static int launch(const double* panels, const int* rows, const int* ws,
                  double* fp, double* u, int* cnt, double* st, double* gs,
                  double* cpy, int Bp, int Lp, int Wp, double thr, double gf,
                  int device, cudaStream_t stream) {
  CHECK(cudaSetDevice(device));
  int sms = 0;
  CHECK(prepare(device, &sms));
  const int nb = Wp < NB ? Wp : NB;
  const int nslab = (Wp + nb - 1) / nb;
  const long long total = (long long)Bp * Lp * Wp;
  const long long nscr = (long long)nslab * Bp * nb;
  unsigned long long* thm = G ? (unsigned long long*)(gs + nscr) : nullptr;
  mask_kernel<<<mask_blocks(total), ENT, 0, stream>>>(
      panels, fp, rows, ws, cnt, nslab * Bp, Lp, Wp, total);
  CHECK(cudaGetLastError());
  if constexpr (G) {
    guard_init_kernel<<<mask_blocks(nscr > Bp ? nscr : Bp), ENT, 0,
                        stream>>>(st, Bp, thm, nscr);
    CHECK(cudaGetLastError());
  }
  const int mp = Lp - Wp;
  if (mp > 0)
    CHECK(cudaMemsetAsync(u, 0, sizeof(double) * (size_t)Bp * mp * mp,
                          stream));
  for (int s = 0; s < nslab; ++s) {
    const int k0 = s * nb;
    const int nbk = nb < Wp - k0 ? nb : Wp - k0;
    const int k1 = k0 + nbk;
    const int nrt = (Lp - k1 + DT - 1) / DT;
    const int nbl = panel_blocks(nrt, Bp, sms);
    CHECK(lane_grid(nbl, Bp));
    const size_t off = (size_t)s * Bp * nb;
    const GuardSlab g =
        G ? GuardSlab{gs + off, thm + off, cpy, nb} : GuardSlab{};
    panel_kernel<G><<<nbl * Bp, PNT, G ? PANEL_SMEM_G : PANEL_SMEM,
                      stream>>>(fp, rows, ws, cnt + (size_t)s * Bp, Lp, Wp,
                                k0, nbk, nbl, g);
    CHECK(cudaGetLastError());
    if constexpr (G) {
      guarded_slab_kernel<<<Bp, GNT, 0, stream>>>(
          fp, rows, ws, st, cnt + (size_t)s * Bp, g, Lp, Wp, k0, nbk, thr,
          gf);
      CHECK(cudaGetLastError());
    }
    CHECK(trailing(fp, rows, ws, Bp, Lp, Wp, k0, nbk, stream));
  }
  return syrk(fp, u, rows, ws, Bp, Lp, Wp, stream);
}

// panels, fp: (Bp, Lp, Wp) fp64; u: (Bp, Lp-Wp, Lp-Wp) fp64 (may be null
// when Lp == Wp); rows, ws: (Bp,) int32; cnt: (ceil(Wp / min(Wp, 64)) * Bp)
// int32 scratch, the panel launches' per-(slab, lane) counters.  Returns a
// cudaError_t code.
extern "C" int fused_factor_syrk_launch(const double* panels, const int* rows,
                                        const int* ws, double* fp, double* u,
                                        int* cnt, int Bp, int Lp, int Wp,
                                        int device, void* stream) {
  return launch<false>(panels, rows, ws, fp, u, cnt, nullptr, nullptr,
                       nullptr, Bp, Lp, Wp, 0.0, 0.0, device,
                       (cudaStream_t)stream);
}

// As fused_factor_syrk_launch, plus st: (Bp, 4) fp64 per-lane status, the
// clamp threshold thr (0: detect only) with gf = GFLOOR_MULT, and the
// scratch: gs (2 nslab Bp nb) fp64, the pivots then the column maxima of
// each slab, and cpy (Bp, Lp, nb) fp64, nb = min(Wp, 64).  After the call
// cnt[s Bp + b] is -1 where lane b took the column sweep on slab s.
extern "C" int fused_factor_syrk_guarded_launch(
    const double* panels, const int* rows, const int* ws, double* fp,
    double* u, double* st, int* cnt, double* gs, double* cpy, int Bp, int Lp,
    int Wp, double thr, double gf, int device, void* stream) {
  return launch<true>(panels, rows, ws, fp, u, cnt, st, gs, cpy, Bp, Lp, Wp,
                      thr, gf, device, (cudaStream_t)stream);
}

extern "C" const char* fused_factor_syrk_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The library's kernel functions for the resource query (tile.cuh's
// func_attrs): out[5] for function i, its name in *name.
extern "C" int fused_factor_syrk_func_attrs(int i, int device, int* out,
                                            const char** name) {
  static const FuncInfo fs[] = {
      {(const void*)mask_kernel, "mask_kernel", ENT, 0},
      {(const void*)guard_init_kernel, "guard_init_kernel", ENT, 0},
      {(const void*)panel_kernel<false>, "panel_kernel<false>", PNT,
       PANEL_SMEM},
      {(const void*)panel_kernel<true>, "panel_kernel<true>", PNT,
       PANEL_SMEM_G},
      {(const void*)guarded_slab_kernel, "guarded_slab_kernel", GNT, 0},
      {(const void*)trailing_kernel, "trailing_kernel", DNT, DMMA_SMEM_BYTES},
      {(const void*)syrk_kernel, "syrk_kernel", DNT, DMMA_SMEM_BYTES},
  };
  return func_attrs(fs, (int)(sizeof(fs) / sizeof(fs[0])), i, device, out,
                    name);
}
