// The shared tile loops of the port's GEMM-shaped kernels, and the CHECK
// macro of their launch functions.
//
// gemm_nt_tile, the scalar loop of syrk_ln.cu and trsm_rlt.cu: one block of
// NT = 256 threads computes a TILE x TILE (64 x 64) fp64 product tile, each
// thread holding a 4 x 4 accumulator; the two operands' row panels stream
// through shared memory in K-chunks of TK = 8, stored transposed with a
// padded stride (TILE + 1) so the inner loop reads without bank conflicts.
// Rows past the operands' extents and columns past K read as zero, so every
// edge is masked and nothing is padded.
//
// dmma_tile_nt, the fp64 tensor-core tile of gemm_nt.cu and of the fused
// kernel's trailing update and SYRK (fused_factor_syrk.cu): the same
// 64 x 64 C = A B^T tile on Hopper's fp64 tensor cores, through
// mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 (DMMA; wgmma has no fp64
// form).  Of the fp64 shapes, m16n8k8 and m16n8k16 reach the card's fp64
// tensor rate; the older m8n8k4 issues at half of it on the H100
// (scripts/dmma_rates.cu).  A block of DNT = 256 threads is 2 x 4 warps,
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
// columns (4 t + g); the fused panel kernel keeps 64-deep rows at 68.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define CHECK(x)                                  \
  do {                                            \
    cudaError_t err_ = (x);                       \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

namespace {

constexpr int TILE = 64;  // output tile edge
constexpr int TK = 8;     // depth of one shared-memory K chunk
constexpr int NT = 256;   // threads per block
constexpr int LDT = TILE + 1;

// acc[i][j] += sum_k A[r][k] * B[c][k] for r = ty + 16 i, c = tx + 16 j,
// k in [0, K), with tx = threadIdx.x % 16 and ty = threadIdx.x / 16.  Rows
// past arows / brows read as zero.  As and Bs hold TK * LDT doubles each.
// No __restrict__: in trsm_rlt.cu, A is the X the kernel writes.  Every
// thread of the block must call it (it holds block barriers).
__device__ __forceinline__ void gemm_nt_tile(const double* A, int lda,
                                             int arows, const double* B,
                                             int ldb, int brows, int K,
                                             double (&acc)[4][4], double* As,
                                             double* Bs) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TILE * TK; e += NT) {
      const int r = e / TK, k = e % TK;
      const bool kin = k0 + k < K;
      As[k * LDT + r] = (r < arows && kin) ? A[(size_t)r * lda + k0 + k] : 0.0;
      Bs[k * LDT + r] = (r < brows && kin) ? B[(size_t)r * ldb + k0 + k] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k * LDT + ty + 16 * i];
        b[i] = Bs[k * LDT + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}


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
// piece; As and Bs hold 64 rows at strides lda and ldb.
template <int NW>
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
    for (int j = 0; j < NJ; ++j) frag_bt(bf[j], Bs, ldb, wc + 8 * j, k);
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

// Stage rows [0, 64) x columns [k0, k0 + DEPTH) of the row-major G (ld) into
// S (row stride LDS) with cp.async, by all NTH threads; the caller commits.
// Each thread owns fixed slots (a column kk and every RSTEP-th row), so a
// chunk costs a few unrolled copies per thread.  A slot at or past nrows or
// K is zero-filled by the copy itself (src-size 0, or 8 for a 16-byte slot
// that straddles K): no byte outside the operand is read, and the source
// address given is then the operand's base.
template <int DEPTH, int LDS, int NTH>
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
    for (int i = 0; i < DT / RSTEP; ++i) {
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
    for (int i = 0; i < DT / RSTEP; ++i) {
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

// acc[i][j][e] += sum_{k < K} A[r][k] B[c][k] for the tile coordinates
// (r, c) = (dmma_row<DNW>(i, e), dmma_col<DNW>(j, e)); rows past arows /
// brows and k past K read as zero.  sm is the block's dynamic shared memory
// (DMMA_SMEM_BYTES, 16-byte aligned).  All DNT threads of the block must
// call it (it holds block barriers).  A ring of DNS stages: while the warps
// multiply chunk c, chunks c + 1 and c + 2 are in flight, and one barrier
// per chunk both publishes chunk c and frees the stage chunk c - 1 used.
__device__ __forceinline__ void dmma_tile_nt(const double* A, int lda,
                                             int arows, const double* B,
                                             int ldb, int brows, int K,
                                             double (&acc)[2][16 / DNW][4],
                                             double* sm) {
  const bool va = dmma_vec(A, lda), vb = dmma_vec(B, ldb);
  const int nk = (K + DK - 1) / DK;
  auto stage = [&](int c) {
    const int s = c % DNS;
    dmma_stage<DK, DLD, DNT>(sm + s * DSTAGE, A, lda, arows, K, c * DK, va);
    dmma_stage<DK, DLD, DNT>(sm + (DNS + s) * DSTAGE, B, ldb, brows, K,
                             c * DK, vb);
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
    dmma_smem<DNW>(sm + s * DSTAGE, DLD, sm + (DNS + s) * DSTAGE, DLD, DK,
                   acc);
  }
  __syncthreads();  // the caller may reuse sm
}

}  // namespace
