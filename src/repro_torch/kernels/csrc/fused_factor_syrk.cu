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

extern "C" const char* fused_factor_syrk_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
