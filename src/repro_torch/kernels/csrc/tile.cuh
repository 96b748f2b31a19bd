// The fp64 tensor-core tiles of the port's GEMM-shaped kernels, the inverse
// of a 64 x 64 lower-triangular block in shared memory, and the CHECK macro
// of their launch functions.
//
// dmma_tile_nt, the fp64 tensor-core tile of gemm_nt.cu, syrk_ln.cu and
// the fused kernel's trailing update and SYRK (fused_factor_syrk.cu), and
// its twin dmma_tile_nn (C = A B with B row-major K x N, the products of
// tri_inv.cu): a 64 x 64 C = A B^T tile on Hopper's fp64 tensor cores,
// through mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 (DMMA; wgmma
// has no fp64 form).  The single-fragment helpers below (dmma, frag_a,
// frag_bt, frag_b, frag_row, frag_col) also serve the blocked 8-wide
// factors of the fused panel kernel and chol_tile.cu.  Of the fp64
// shapes, m16n8k8 and m16n8k16 reach the card's fp64 tensor rate; the
// older m8n8k4 issues at half of it on the H100 (scripts/dmma_rates.cu).
// A block of DNT = 256 threads is 2 x 4 warps,
// each owning a 32 x 16 piece of the tile as 2 x 2 fragments of 16 x 8
// (32 accumulator registers); two warps share each of the SM's four
// schedulers, so one stages its copies while the other multiplies.  For
// one k8 step a warp loads 2 A and 2 B fragments from shared memory and
// issues 4 independent DMMAs.  (dmma_smem and dmma_row / dmma_col take the
// warp count as a parameter: the fused panel kernel runs 4 warps of
// 32 x 32.)  Fragment
// layout of m16n8k8, g = lane / 4, t = lane % 4: a = A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4] of the 16 x 8 row-major A; b = rows t and t + 4,
// column g of the 8 x 8 .col operand, which for a row-major N x K B is
// B[g][t], B[g][t+4]; c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
// So both operands sit in shared memory as rows with k contiguous, exactly
// as they lie in global memory.
//   Staging: K-chunks of DK = 32 through a ring of three shared stages
// (108 KB of dynamic shared memory, two blocks an SM), filled with
// cp.async two chunks ahead of the warps' multiply, one barrier per
// chunk.  Each thread owns fixed copy slots, so staging a chunk costs a
// few unrolled instructions.  A 16-byte copy
// needs a 16-byte aligned source: each operand takes 16-byte copies only
// when its base address is 16-byte aligned and its leading dimension is
// even (every row then starts aligned, and chunk offsets are even);
// otherwise 8-byte copies.  The kernel decides per operand, so row and
// column slices with any ld and any offset work.  Cells past the operand's
// rows or past K are zero-filled by the copy (cp.async's src-size 0, which
// reads nothing; a 16-byte copy that straddles K reads its first 8 bytes):
// out-of-range memory is never read, since 0 * NaN would be NaN.
//   Banks: an fp64 value spans two of the 32 four-byte banks, so a warp's
// 64-bit fragment load is served as two half-warps of 16 lanes, g in
// [0, 4) x t in [0, 4), at row g, column t (or t + 4) of the staged rows.
// With a row stride of DK + 4 = 36 doubles (36 mod 16 = 4), lane (g, t)
// lands on 8-byte bank pair (4 g + t) mod 16: all 16 distinct, so the
// loads are conflict-free; the stride is also a multiple of 2 doubles, so
// every 16-byte cp.async destination stays aligned.  Any stride = 4
// (mod 16) does the same, and so does reading a row-major K x N operand by
// columns (4 t + g): dmma_tile_nn stages B as 32 rows of 64 at stride 68,
// and the 64 x 64 blocks of the panel kernel and the triangular inverse
// keep rows of 68.
//   The triangular inverse (tri_inv8_diag, tri_inv64_doubling): the eight
// 8 x 8 diagonal blocks by forward substitution in registers, then the
// doubling inv([A 0; C B]) = [A^-1 0; -B^-1 C A^-1  B^-1] on DMMA
// fragments for h = 8, 16, 32, by a block of 4 warps (the fused panel
// kernel, tri_inv.cu's diagonal blocks, trsm_rlt.cu's steps).  Before
// them, chol8_rsqrt: a warp's Cholesky of an 8 x 8 block in registers,
// the serial step of the fused panel kernel's and chol_tile.cu's blocked
// factors.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define CHECK(x)                                  \
  do {                                            \
    cudaError_t err_ = (x);                       \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

namespace {

// ---------------------------------------------------------------------------
// fp64 tensor-core (DMMA) tile
// ---------------------------------------------------------------------------
constexpr int DT = 64;              // output tile edge
constexpr int DK = 32;              // depth of one staged K chunk
constexpr int DNW = 8;              // warps of dmma_tile_nt: 2 x 4 of 32 x 16
constexpr int DNT = 32 * DNW;       // its threads
constexpr int DLD = DK + 4;         // staged row stride (= 4 mod 16)
constexpr int DNS = 3;              // stages in the cp.async ring
constexpr int DSTAGE = DT * DLD;    // doubles of one operand's stage
// dynamic shared memory of dmma_tile_nt: 2 operands x DNS stages (108 KB,
// so two blocks fit an SM)
constexpr int DMMA_SMEM_BYTES = 2 * DNS * DSTAGE * (int)sizeof(double);

// c += a * b on one m16n8k8 fp64 fragment (see the note above)
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Fragments from shared memory, for the warp's lane (g = lane / 4,
// t = lane % 4).  A: the 16 x 8 block at (r0, k0) of a row-major S (ld).
__device__ __forceinline__ void frag_a(double (&a)[4], const double* S,
                                       int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double* p = S + (r0 + g) * ld + k0 + t;
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}
// B of C = A B^T: the 8 x 8 block at (c0, k0) of a row-major N x K S.
__device__ __forceinline__ void frag_bt(double (&b)[2], const double* S,
                                        int ld, int c0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double* p = S + (c0 + g) * ld + k0 + t;
  b[0] = p[0];
  b[1] = p[4];
}
// B of C = A B: the 8 x 8 block at (k0, c0) of a row-major K x N S.
__device__ __forceinline__ void frag_b(double (&b)[2], const double* S,
                                       int ld, int k0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double* p = S + (k0 + t) * ld + c0 + g;
  b[0] = p[0];
  b[1] = p[4 * ld];
}
// Row and column of c[e] in the 16 x 8 fragment at (r0, c0).
__device__ __forceinline__ int frag_row(int r0, int e) {
  return r0 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int c0, int e) {
  return c0 + 2 * (threadIdx.x & 3) + (e & 1);
}

// The NW warps of a DMMA block sit 2 (rows) x NW / 2 (columns), each
// owning a 32 x (128 / NW) piece of the 64 x 64 tile as 2 x (16 / NW)
// fragments of 16 x 8: acc[i][j][e] lies at row dmma_row<NW>(i, e), column
// dmma_col<NW>(j, e).
template <int NW>
__device__ __forceinline__ int dmma_row(int i, int e) {
  return frag_row((threadIdx.x >> 5) / (NW / 2) * 32 + 16 * i, e);
}
template <int NW>
__device__ __forceinline__ int dmma_col(int j, int e) {
  return frag_col((threadIdx.x >> 5) % (NW / 2) * (128 / NW) + 8 * j, e);
}

// acc += As Bs^T over k in [0, depth) (a multiple of 8) for the warp's
// piece; As and Bs hold 64 rows at strides lda and ldb.  With BT false,
// acc += As Bs instead: Bs holds depth rows of 64 columns (a row-major
// K x N operand, read by columns).
template <int NW, bool BT = true>
__device__ __forceinline__ void dmma_smem(const double* As, int lda,
                                          const double* Bs, int ldb,
                                          int depth,
                                          double (&acc)[2][16 / NW][4]) {
  constexpr int NJ = 16 / NW;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / (NW / 2) * 32, wc = warp % (NW / 2) * (128 / NW);
#pragma unroll 1
  for (int k = 0; k < depth; k += 8) {
    double af[2][4], bf[NJ][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) frag_a(af[i], As, lda, wr + 16 * i, k);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if constexpr (BT)
        frag_bt(bf[j], Bs, ldb, wc + 8 * j, k);
      else
        frag_b(bf[j], Bs, ldb, k, wc + 8 * j);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dmma(acc[i][j], af[i], bf[j]);
  }
}

// Whether an operand may take 16-byte copies: aligned base, even ld.
__device__ __forceinline__ bool dmma_vec(const double* G, int ld) {
  return (((uintptr_t)G & 15) == 0) && ((ld & 1) == 0);
}

// Stage rows [0, ROWS) x columns [k0, k0 + DEPTH) of the row-major G (ld)
// into S (row stride LDS) with cp.async, by all NTH threads; the caller
// commits.  Each thread owns fixed slots (a column kk and every RSTEP-th
// row), so a chunk costs a few unrolled copies per thread.  A slot at or
// past nrows or K is zero-filled by the copy itself (src-size 0, or 8 for a
// 16-byte slot that straddles K): no byte outside the operand is read, and
// the source address given is then the operand's base.
template <int DEPTH, int LDS, int NTH, int ROWS = DT>
__device__ __forceinline__ void dmma_stage(double* S, const double* G, int ld,
                                           int nrows, int K, int k0,
                                           bool vec) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(S);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int PER_ROW = DEPTH / 2, RSTEP = NTH / PER_ROW;
    const int kk = 2 * (tid % PER_ROW), r0 = tid / PER_ROW;
    const int left = K - (k0 + kk);
    const int kb = left >= 2 ? 16 : (left == 1 ? 8 : 0);
#pragma unroll
    for (int i = 0; i < ROWS / RSTEP; ++i) {
      const int r = r0 + i * RSTEP;
      const int n = r < nrows ? kb : 0;
      const double* src = n ? G + (size_t)r * ld + k0 + kk : G;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       s + 8u * (r * LDS + kk)),
                   "l"(src), "r"(n));
    }
  } else {
    constexpr int RSTEP = NTH / DEPTH;
    const int kk = tid % DEPTH, r0 = tid / DEPTH;
    const int kb = k0 + kk < K ? 8 : 0;
#pragma unroll
    for (int i = 0; i < ROWS / RSTEP; ++i) {
      const int r = r0 + i * RSTEP;
      const int n = r < nrows ? kb : 0;
      const double* src = n ? G + (size_t)r * ld + k0 + kk : G;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                       s + 8u * (r * LDS + kk)),
                   "l"(src), "r"(n));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring of dmma_tile_nt and dmma_tile_nn: acc[i][j][e] += the product
// at the tile coordinates (r, c) = (dmma_row<DNW>(i, e), dmma_col<DNW>(j,
// e)).  A is k-contiguous, rows past arows and k past K read as zero.  B
// (BT): N x K, k-contiguous, rows past bn zero; B (!BT): K x N, row-major,
// columns past bn zero, a chunk staged as DK rows of 64 at stride DLDN
// (which fits a stage of DSTAGE doubles).  sm is the block's dynamic shared
// memory (DMMA_SMEM_BYTES, 16-byte aligned).  All DNT threads of the block
// must call it (it holds block barriers).  A ring of DNS stages: while the
// warps multiply chunk c, chunks c + 1 and c + 2 are in flight, and one
// barrier per chunk both publishes chunk c and frees the stage chunk c - 1
// used.
constexpr int DLDN = DT + 4;  // stride of a staged K x N chunk (= 4 mod 16)
static_assert(DK * DLDN <= DSTAGE, "a K x N chunk must fit a stage");

template <bool BT>
__device__ __forceinline__ void dmma_tile(const double* A, int lda,
                                          int arows, const double* B,
                                          int ldb, int bn, int K,
                                          double (&acc)[2][16 / DNW][4],
                                          double* sm) {
  const bool va = dmma_vec(A, lda), vb = dmma_vec(B, ldb);
  const int nk = (K + DK - 1) / DK;
  auto stage = [&](int c) {
    const int s = c % DNS;
    dmma_stage<DK, DLD, DNT>(sm + s * DSTAGE, A, lda, arows, K, c * DK, va);
    if constexpr (BT)
      dmma_stage<DK, DLD, DNT>(sm + (DNS + s) * DSTAGE, B, ldb, bn, K,
                               c * DK, vb);
    else
      dmma_stage<DT, DLDN, DNT, DK>(sm + (DNS + s) * DSTAGE,
                                    B + (size_t)c * DK * ldb, ldb,
                                    K - c * DK, bn, 0, vb);
  };
#pragma unroll
  for (int c = 0; c < DNS - 1; ++c) {
    if (c < nk) stage(c);
    cp_async_commit();  // possibly empty: one group per chunk
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<DNS - 2>();
    __syncthreads();
    if (c + DNS - 1 < nk) stage(c + DNS - 1);
    cp_async_commit();
    const int s = c % DNS;
    dmma_smem<DNW, BT>(sm + s * DSTAGE, DLD, sm + (DNS + s) * DSTAGE,
                       BT ? DLD : DLDN, DK, acc);
  }
  __syncthreads();  // the caller may reuse sm
}

// acc += A B^T over k < K: A (arows x K), B (brows x K), both k-contiguous.
__device__ __forceinline__ void dmma_tile_nt(const double* A, int lda,
                                             int arows, const double* B,
                                             int ldb, int brows, int K,
                                             double (&acc)[2][16 / DNW][4],
                                             double* sm) {
  dmma_tile<true>(A, lda, arows, B, ldb, brows, K, acc, sm);
}

// acc += A B over k < K: A (arows x K) k-contiguous, B (K x bcols)
// row-major, as the triangular inverse's products need.
__device__ __forceinline__ void dmma_tile_nn(const double* A, int lda,
                                             int arows, const double* B,
                                             int ldb, int bcols, int K,
                                             double (&acc)[2][16 / DNW][4],
                                             double* sm) {
  dmma_tile<false>(A, lda, arows, B, ldb, bcols, K, acc, sm);
}


// The Cholesky factor of an 8 x 8 block held by a warp, lane i (mod 8)
// holding row i in a[] (cells above the diagonal are never read, and come
// out zero): for each column q the pivot x gives rq[q] = rsqrt(x), L_qq =
// x rq[q] and the column below scaled by rq[q] -- no division; a pivot
// <= 0 gives NaN, as sqrt does -- then the update of the columns right of
// q, each row of the column read from its lane.  All 32 lanes call it (the
// 8-wide factors of the fused panel kernel and of chol_tile.cu).  The form
// with xi also gives lane i the pivot x of column i, before its rsqrt (the
// guarded panel kernel's status and check).
__device__ __forceinline__ void chol8_rsqrt(double (&a)[8], double (&rq)[8],
                                            int i, double& xi) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const double x = __shfl_sync(0xffffffffu, a[q], q);
    if (i == q) xi = x;
    rq[q] = rsqrt(x);
    a[q] = i == q ? x * rq[q] : (i > q ? a[q] * rq[q] : 0.0);
#pragma unroll
    for (int p = q + 1; p < 8; ++p) {
      const double lpq = __shfl_sync(0xffffffffu, a[q], p);
      if (i >= p) a[p] -= a[q] * lpq;
    }
  }
}
__device__ __forceinline__ void chol8_rsqrt(double (&a)[8], double (&rq)[8],
                                            int i) {
  double xi;
  chol8_rsqrt(a, rq, i, xi);
}

// ---------------------------------------------------------------------------
// Inverse of a 64 x 64 lower-triangular block in shared memory (the fused
// panel kernel, tri_inv.cu's diagonal blocks, trsm_rlt.cu's steps), by a
// block of exactly 4 warps.  Blocks are held at row stride TLD; the
// doubling's products need TPSZ doubles of scratch.
// ---------------------------------------------------------------------------
constexpr int TLD = DT + 4;      // row stride of a 64 x 64 block (4 mod 16)
constexpr int TPS = 32 + 4;      // stride of the doubling's products
constexpr int TPSZ = 32 * TPS;   // doubles of those products

// Li's eight 8 x 8 diagonal blocks = the inverses of L's, by warps 0 and 1
// (four blocks a warp, lane i of each 8-lane group holding row i): column
// i by forward substitution, x[r] = (delta_ri - sum_{p<r} L[r][p] x[p]) /
// L[r][r], with L's rows read from their lanes.  Reads only the lower
// triangle of each block; writes its zeros above the diagonal too.
__device__ __forceinline__ void tri_inv8_diag(const double* L, double* Li) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 2) return;
  const int j0 = 8 * (4 * warp + (lane >> 3)), i = lane & 7;
  double a[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) a[p] = p < i ? L[(j0 + i) * TLD + j0 + p] : 0.0;
  const double rd = 1.0 / L[(j0 + i) * TLD + j0 + i];
  double x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    double s = r == i ? 1.0 : 0.0;
#pragma unroll
    for (int p = 0; p < r; ++p)
      s -= __shfl_sync(0xffffffffu, a[p], r, 8) * x[p];
    const double rr = __shfl_sync(0xffffffffu, rd, r, 8);
    x[r] = r < i ? 0.0 : s * rr;
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) Li[(j0 + p) * TLD + j0 + i] = x[p];
}

// Li = L^-1 by recursive doubling from the 8 x 8 inverses already in Li's
// diagonal blocks (Li zero above them): for each pair of h-wide diagonal
// blocks with inverses A^-1, B^-1 and the block C below A,
//     inv([A 0; C B]) = [A^-1 0; -B^-1 C A^-1  B^-1],
// as the two products P = C A^-1 and -B^-1 P on DMMA, every pair of a level
// at once (h = 8, 16, 32; 5 barriers).  Reads only L's blocks below the
// diagonal.  All 4 warps call it; the caller syncs before reading Li.
__device__ __forceinline__ void tri_inv64_doubling(const double* L,
                                                   double* Li, double* P) {
  const int warp = threadIdx.x >> 5;
  {  // h = 8: a warp per pair (16-row fragments, the first 8 rows kept)
    const int base = 16 * warp;
    double a[4], bb[2], c[4] = {0.0, 0.0, 0.0, 0.0};
    frag_a(a, L, TLD, base + 8, base);
    frag_b(bb, Li, TLD, base, base);
    dmma(c, a, bb);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      P[(base / 2 + frag_row(0, e)) * TPS + frag_col(0, e)] = c[e];
    __syncwarp();
    c[0] = c[1] = c[2] = c[3] = 0.0;
    frag_a(a, Li, TLD, base + 8, base + 8);
    frag_b(bb, P, TPS, base / 2, 0);
    dmma(c, a, bb);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      Li[(base + 8 + frag_row(0, e)) * TLD + base + frag_col(0, e)] = -c[e];
  }
  __syncthreads();
  {  // h = 16: warp = (pair, 8-column half)
    const int base = 32 * (warp >> 1), q = warp & 1;
    double a[4], bb[2], c[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      frag_a(a, L, TLD, base + 16, base + 8 * s);
      frag_b(bb, Li, TLD, base + 8 * s, base + 8 * q);
      dmma(c, a, bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      P[(base / 2 + frag_row(0, e)) * TPS + frag_col(8 * q, e)] = c[e];
    __syncthreads();
    c[0] = c[1] = c[2] = c[3] = 0.0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      frag_a(a, Li, TLD, base + 16, base + 16 + 8 * s);
      frag_b(bb, P, TPS, base / 2 + 8 * s, 8 * q);
      dmma(c, a, bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Li[(base + 16 + frag_row(0, e)) * TLD + base + frag_col(8 * q, e)] =
          -c[e];
  }
  __syncthreads();
  {  // h = 32: warp = (16-row tile, two 8-column tiles)
    const int mi = warp >> 1, nj = 2 * (warp & 1);
    double a[4], bb[2], c[2][4] = {};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      frag_a(a, L, TLD, 32 + 16 * mi, 8 * s);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        frag_b(bb, Li, TLD, 8 * s, 8 * (nj + j));
        dmma(c[j], a, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        P[frag_row(16 * mi, e) * TPS + frag_col(8 * (nj + j), e)] = c[j][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      frag_a(a, Li, TLD, 32 + 16 * mi, 32 + 8 * s);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        frag_b(bb, P, TPS, 8 * s, 8 * (nj + j));
        dmma(c[j], a, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Li[(32 + frag_row(16 * mi, e)) * TLD + frag_col(8 * (nj + j), e)] =
            -c[j][e];
  }
}

// ---------------------------------------------------------------------------
// Resource query: each library lists its kernel functions with the threads
// and dynamic shared bytes its launches give them, and exports
// <library>_func_attrs over that list for the static analysis's resource
// model (repro_torch.analyze.kernel_check.KERNEL_FUNCS, same order).
// ---------------------------------------------------------------------------
struct FuncInfo {
  const void* fn;
  const char* name;
  int threads;  // threads per block of its launches
  int dyn;      // dynamic shared bytes of its launches
};

// For function i of fs: its name, and out = {static shared bytes, max
// threads per block, registers per thread, dynamic shared bytes, threads}
// (the first three from cudaFuncGetAttributes).  cudaErrorInvalidValue
// past the last function.
int func_attrs(const FuncInfo* fs, int n, int i, int device, int* out,
               const char** name) {
  if (i < 0 || i >= n) return (int)cudaErrorInvalidValue;
  CHECK(cudaSetDevice(device));
  cudaFuncAttributes a;
  CHECK(cudaFuncGetAttributes(&a, fs[i].fn));
  out[0] = (int)a.sharedSizeBytes;
  out[1] = a.maxThreadsPerBlock;
  out[2] = a.numRegs;
  out[3] = fs[i].dyn;
  out[4] = fs[i].threads;
  *name = fs[i].name;
  return 0;
}

}  // namespace
