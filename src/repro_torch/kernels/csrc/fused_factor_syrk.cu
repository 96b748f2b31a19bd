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
//   1. mask pass over all cells;
//   2. per 64-column slab [k0, k1), three launches:
//        diag_factor_kernel  one block per lane factors the 64x64 diagonal
//                            block in shared memory (right-looking, rank-1);
//        panel_trsm_kernel   one block per (lane, 64-row tile) of the rows
//                            below the slab solves X L11^T = A by the same
//                            rank-1 column sweep;
//        trailing_kernel     one block per (lane, row tile, column tile on or
//                            below the diagonal) subtracts the slab's
//                            product from the trailing real columns;
//   3. syrk_kernel: one block per (lane, tile ti, tile tj <= ti) of U, tiles
//      at or past m are skipped (u is zeroed with one memset first).
// Lanes whose width w <= k0 exit at once, as pl.when(k0 < w) does on the
// TPU; tiles with no live rows or lying wholly above the diagonal exit too.
// All launches go on the caller's stream; the kernel allocates nothing.
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
// real columns.  It replaces diag_factor_kernel + panel_trsm_kernel for the
// slab; trailing_kernel and syrk_kernel are unchanged, so a guarded slab
// costs 2 launches instead of 3.  The status (min unclamped d^2, n clamped,
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
// bytes at 3.35 TB/s (2.0 on PCIe) for the small ones.  This first version
// does scalar fp64 FMAs (4x4 per thread, 64x64 tiles), so it can reach at
// most the 34 TFLOP/s non-tensor fp64 rate and is shared-memory bound well
// below that.  Left for later: DMMA (mma.sync f64) tiles, TMA staging, and a
// persistent kernel that removes the 3 launches per 64-column slab.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NB = 64;          // slab width
constexpr int TILE = 64;        // output tile edge of the GEMM-shaped kernels
constexpr int TK = 8;           // depth of one shared-memory K chunk
constexpr int NT = 256;         // threads per block
constexpr int LDS = NB + 1;     // padded shared row stride
constexpr int TRSM_SMEM = 2 * NB * LDS * (int)sizeof(double);

// acc[i][j] += sum_k A[r][k] * B[c][k] for r = ty + 16 i, c = tx + 16 j,
// k in [0, K); A and B row-major with k contiguous.  Rows past arows/brows
// read as zero.
__device__ __forceinline__ void gemm_nt_tile(
    const double* __restrict__ A, int lda, int arows,
    const double* __restrict__ B, int ldb, int brows, int K,
    double (&acc)[4][4], double* As, double* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TILE * TK; e += NT) {
      const int r = e / TK, k = e % TK;
      const bool kin = k0 + k < K;
      As[k * (TILE + 1) + r] =
          (r < arows && kin) ? A[(size_t)r * lda + k0 + k] : 0.0;
      Bs[k * (TILE + 1) + r] =
          (r < brows && kin) ? B[(size_t)r * ldb + k0 + k] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k * (TILE + 1) + ty + 16 * i];
        b[i] = Bs[k * (TILE + 1) + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void mask_kernel(const double* __restrict__ in,
                            double* __restrict__ fp,
                            const int* __restrict__ rows,
                            const int* __restrict__ ws, int Lp, int Wp,
                            long long total) {
  const long long per = (long long)Lp * Wp;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(idx / per);
    const int rem = (int)(idx - (long long)b * per);
    const int r = rem / Wp, c = rem - r * Wp;
    const int w = ws[b], m = rows[b] - w;
    const bool keep =
        c < w && ((r < w && r >= c) || (r >= Wp && r < Wp + m));
    fp[idx] = keep ? in[idx] : ((r == c && r >= w) ? 1.0 : 0.0);
  }
}

__global__ void diag_factor_kernel(double* __restrict__ fp,
                                   const int* __restrict__ ws, int Lp,
                                   int Wp, int k0, int nbk) {
  const int b = blockIdx.x, tid = threadIdx.x;
  if (ws[b] <= k0) return;
  __shared__ double Ls[NB * LDS];
  double* panel = fp + (size_t)b * Lp * Wp;
  for (int e = tid; e < nbk * nbk; e += NT) {
    const int i = e / nbk, p = e % nbk;
    Ls[i * LDS + p] = p <= i ? panel[(size_t)(k0 + i) * Wp + k0 + p] : 0.0;
  }
  for (int j = 0; j < nbk; ++j) {
    __syncthreads();
    const double d = sqrt(Ls[j * LDS + j]);
    for (int i = j + 1 + tid; i < nbk; i += NT) Ls[i * LDS + j] /= d;
    __syncthreads();
    if (tid == 0) Ls[j * LDS + j] = d;
    const int rem = nbk - j - 1;
    for (int e = tid; e < rem * rem; e += NT) {
      const int i = j + 1 + e / rem, p = j + 1 + e % rem;
      if (p <= i) Ls[i * LDS + p] -= Ls[i * LDS + j] * Ls[p * LDS + j];
    }
  }
  __syncthreads();
  for (int e = tid; e < nbk * nbk; e += NT) {
    const int i = e / nbk, p = e % nbk;
    panel[(size_t)(k0 + i) * Wp + k0 + p] = p <= i ? Ls[i * LDS + p] : 0.0;
  }
}

__global__ void panel_trsm_kernel(double* __restrict__ fp,
                                  const int* __restrict__ rows,
                                  const int* __restrict__ ws, int Lp, int Wp,
                                  int k0, int nbk) {
  const int b = blockIdx.y, tid = threadIdx.x;
  const int w = ws[b];
  if (w <= k0) return;
  const int m = rows[b] - w;
  const int k1 = k0 + nbk;
  const int r0 = k1 + blockIdx.x * TILE;
  const int r1 = min(r0 + TILE, Lp);
  // live rows below the slab: [k1, w) and [Wp, Wp + m); the rest are zero
  if (!(r0 < w || (r0 < Wp + m && r1 > Wp))) return;
  extern __shared__ double sm[];
  double* Ls = sm;
  double* X = sm + NB * LDS;
  double* panel = fp + (size_t)b * Lp * Wp;
  const int nr = r1 - r0;
  for (int e = tid; e < nbk * nbk; e += NT) {
    const int i = e / nbk, p = e % nbk;
    Ls[i * LDS + p] = panel[(size_t)(k0 + i) * Wp + k0 + p];
  }
  for (int e = tid; e < nr * nbk; e += NT) {
    const int r = e / nbk, p = e % nbk;
    X[r * LDS + p] = panel[(size_t)(r0 + r) * Wp + k0 + p];
  }
  __syncthreads();
  for (int j = 0; j < nbk; ++j) {
    for (int r = tid; r < nr; r += NT) X[r * LDS + j] /= Ls[j * LDS + j];
    __syncthreads();
    const int rem = nbk - j - 1;
    for (int e = tid; e < nr * rem; e += NT) {
      const int r = e / rem, p = j + 1 + e % rem;
      X[r * LDS + p] -= X[r * LDS + j] * Ls[p * LDS + j];
    }
    __syncthreads();
  }
  for (int e = tid; e < nr * nbk; e += NT) {
    const int r = e / nbk, p = e % nbk;
    panel[(size_t)(r0 + r) * Wp + k0 + p] = X[r * LDS + p];
  }
}

__global__ void trailing_kernel(double* __restrict__ fp,
                                const int* __restrict__ rows,
                                const int* __restrict__ ws, int Lp, int Wp,
                                int k0, int nbk, int nct) {
  const int b = blockIdx.y, tid = threadIdx.x;
  const int w = ws[b];
  const int k1 = k0 + nbk;
  if (w <= k1) return;  // no real column right of the slab
  const int m = rows[b] - w;
  const int ct = blockIdx.x % nct, rt = blockIdx.x / nct;
  const int c0 = k1 + ct * TILE, r0 = k1 + rt * TILE;
  if (c0 >= w) return;            // identity columns receive no update
  if (r0 + TILE <= c0) return;    // tile wholly above the diagonal
  const int r1 = min(r0 + TILE, Lp);
  if (!(r0 < w || (r0 < Wp + m && r1 > Wp))) return;
  __shared__ double As[TK * (TILE + 1)], Bs[TK * (TILE + 1)];
  double acc[4][4] = {};
  double* panel = fp + (size_t)b * Lp * Wp;
  gemm_nt_tile(panel + (size_t)r0 * Wp + k0, Wp, r1 - r0,
               panel + (size_t)c0 * Wp + k0, Wp, min(TILE, Wp - c0), nbk,
               acc, As, Bs);
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r < Lp && c < Wp && r >= c) panel[(size_t)r * Wp + c] -= acc[i][j];
    }
}

__global__ void syrk_kernel(const double* __restrict__ fp,
                            double* __restrict__ u,
                            const int* __restrict__ rows,
                            const int* __restrict__ ws, int Lp, int Wp,
                            int nt) {
  const int b = blockIdx.y, tid = threadIdx.x;
  const int w = ws[b], m = rows[b] - w, mp = Lp - Wp;
  const int rt = blockIdx.x / nt, ct = blockIdx.x % nt;
  if (ct > rt) return;
  const int r0 = rt * TILE, c0 = ct * TILE;
  if (r0 >= m) return;  // c0 <= r0, so the whole tile is past the tail
  __shared__ double As[TK * (TILE + 1)], Bs[TK * (TILE + 1)];
  double acc[4][4] = {};
  const double* T = fp + (size_t)b * Lp * Wp + (size_t)Wp * Wp;
  // columns >= w of the tail are zero: the product stops at w
  gemm_nt_tile(T + (size_t)r0 * Wp, Wp, min(TILE, m - r0),
               T + (size_t)c0 * Wp, Wp, min(TILE, m - c0), w, acc, As, Bs);
  const int tx = tid % 16, ty = tid / 16;
  double* ub = u + (size_t)b * mp * mp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r < m && c < m && r >= c) ub[(size_t)r * mp + c] = acc[i][j];
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

#define CHECK(x)                                  \
  do {                                            \
    cudaError_t err_ = (x);                       \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// panels, fp: (Bp, Lp, Wp) fp64; u: (Bp, Lp-Wp, Lp-Wp) fp64 (may be null
// when Lp == Wp); rows, ws: (Bp,) int32.  Returns a cudaError_t code.
extern "C" int fused_factor_syrk_launch(const double* panels, const int* rows,
                                        const int* ws, double* fp, double* u,
                                        int Bp, int Lp, int Wp, int device,
                                        void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  CHECK(cudaFuncSetAttribute(panel_trsm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TRSM_SMEM));
  const long long total = (long long)Bp * Lp * Wp;
  const long long want = (total + NT - 1) / NT;
  const int blocks = (int)(want < 132LL * 32 ? want : 132LL * 32);
  mask_kernel<<<blocks, NT, 0, stream>>>(panels, fp, rows, ws, Lp, Wp, total);
  CHECK(cudaGetLastError());
  const int mp = Lp - Wp;
  if (mp > 0)
    CHECK(cudaMemsetAsync(u, 0, sizeof(double) * (size_t)Bp * mp * mp,
                          stream));
  const int nb = Wp < NB ? Wp : NB;
  for (int k0 = 0; k0 < Wp; k0 += nb) {
    const int nbk = nb < Wp - k0 ? nb : Wp - k0;
    const int k1 = k0 + nbk;
    diag_factor_kernel<<<Bp, NT, 0, stream>>>(fp, ws, Lp, Wp, k0, nbk);
    CHECK(cudaGetLastError());
    const int nrt = (Lp - k1 + TILE - 1) / TILE;
    if (nrt > 0) {
      panel_trsm_kernel<<<dim3(nrt, Bp), NT, TRSM_SMEM, stream>>>(
          fp, rows, ws, Lp, Wp, k0, nbk);
      CHECK(cudaGetLastError());
    }
    const int nct = (Wp - k1 + TILE - 1) / TILE;
    if (nct > 0) {
      trailing_kernel<<<dim3(nrt * nct, Bp), NT, 0, stream>>>(
          fp, rows, ws, Lp, Wp, k0, nbk, nct);
      CHECK(cudaGetLastError());
    }
  }
  if (mp > 0) {
    const int nt = (mp + TILE - 1) / TILE;
    syrk_kernel<<<dim3(nt * nt, Bp), NT, 0, stream>>>(fp, u, rows, ws, Lp, Wp,
                                                       nt);
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
  const long long total = (long long)Bp * Lp * Wp;
  const long long want = (total + NT - 1) / NT;
  const int blocks = (int)(want < 132LL * 32 ? want : 132LL * 32);
  mask_kernel<<<blocks, NT, 0, stream>>>(panels, fp, rows, ws, Lp, Wp, total);
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
    const int nrt = (Lp - k1 + TILE - 1) / TILE;
    const int nct = (Wp - k1 + TILE - 1) / TILE;
    if (nct > 0) {
      trailing_kernel<<<dim3(nrt * nct, Bp), NT, 0, stream>>>(
          fp, rows, ws, Lp, Wp, k0, nbk, nct);
      CHECK(cudaGetLastError());
    }
  }
  if (mp > 0) {
    const int nt = (mp + TILE - 1) / TILE;
    syrk_kernel<<<dim3(nt * nt, Bp), NT, 0, stream>>>(fp, u, rows, ws, Lp, Wp,
                                                       nt);
    CHECK(cudaGetLastError());
  }
  return 0;
}

extern "C" const char* fused_factor_syrk_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
