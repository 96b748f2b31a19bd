// Right-side lower-transposed triangular solve for Hopper, fp64: X L^T = B
// for L (W, W) lower triangular and B (M, W); rows contiguous, leading
// dimensions ldb, ldl, ldx.
//
// Replaces the TPU kernel src/repro/kernels/trsm.py::trsm_rlt
// (_first_step_kernel, _step_kernel) for any B: the TRSM the sequential
// path applies to a supernode's rectangular part after POTRF
// (ops.factor_panel).  Like the reference (and MAGMA) it inverts only the
// 64 x 64 diagonal blocks D_j of L and does products everywhere else:
//
//     X_j = (B_j - X_{<j} L[j, <j]^T) D_j^-T      for block column j,
//
// so its error follows cond(D_j), not cond(L).  The explicit inverse of the
// whole L is never formed.
//
// Design: a row of X depends only on the same row of B, so one block of 4
// warps owns RT = 16 rows of X and sweeps all block columns j in order
// inside one launch (the reference makes one pallas_call per block column,
// since its grid carries the order); M = 1200 gives 75 blocks.  Per step:
//   * L_jj is copied into shared memory and inverted there by tile.cuh's
//     8 x 8 forward substitution and doubling on DMMA, while the first
//     chunks of the product below are in flight: the inversion the
//     reference does in a separate XLA call is folded into the kernel, so
//     a call is one launch and allocates nothing but X;
//   * T = B_j - X_{<j} L[j, <j]^T on DMMA (mma.sync m16n8k8 f64), K in
//     32-deep chunks through a 3-stage cp.async ring (tile.cuh's
//     dmma_stage picks 16- or 8-byte copies per operand, so any ld and
//     offset work), each warp owning a 16 x 16 piece;
//   * X_j = T D_j^-T on DMMA, stored.
// A block reads back only the columns of X it wrote itself, after a
// barrier, so no cross-block ordering is needed.  L_jj of a partial last
// block is padded with the identity in shared memory, so W need not be a
// multiple of 64; rows of B past M are masked.  L is read on and below the
// diagonal blocks only, and their upper halves are never used.
//
// Bound on this card: M W^2 flops against 8 (W (W+1)/2 + 2 M W) bytes:
// flop-bound at the fp64 tensor-core peak (67 TFLOP/s SXM) for the wide
// panels of the sequential path.  Each block repeats the 64^3/3-flop
// inversion of every D_j (small next to its 16 W^2 flops), and its sweep
// is sequential, so a call takes at least one block's sweep.
#include "tile.cuh"

namespace {

constexpr int RT = 16;             // rows of X a block owns
constexpr int TNT = 128;           // threads (4 warps of 16 x 16)
constexpr int ASTAGE = RT * DLD;   // one stage of the X_{<j} ring
// the two rings, L_jj and its inverse (rows of TLD), and the doubling's
// products (which then hold T): 147,968 bytes
constexpr int TRSM_SMEM =
    (DNS * (ASTAGE + DSTAGE) + 2 * DT * TLD + TPSZ) * (int)sizeof(double);
static_assert(RT * TLD <= TPSZ, "T shares the doubling's scratch");

__global__ void __launch_bounds__(TNT)
    trsm_rlt_kernel(const double* B, int ldb, const double* L, int ldl,
                    double* X, int ldx, int M, int W) {
  const int r0 = blockIdx.x * RT, nr = min(RT, M - r0);
  const int tid = threadIdx.x, wc = 16 * (tid >> 5);
  extern __shared__ __align__(16) double sm[];
  double* As = sm;                   // ring: X_{<j} rows of this block
  double* Bs = As + DNS * ASTAGE;    // ring: L[j, <j]
  double* D = Bs + DNS * DSTAGE;     // L_jj, padded with the identity
  double* Li = D + DT * TLD;         // D_j^-1
  double* P = Li + DT * TLD;         // the doubling's products, then T
  const double* Bb = B + (size_t)r0 * ldb;
  double* Xb = X + (size_t)r0 * ldx;
  const bool vx = dmma_vec(Xb, ldx), vl = dmma_vec(L, ldl);
  // Li stays zero above its diagonal 8 x 8 blocks: nothing writes there
  for (int e = tid; e < DT * DT; e += TNT) Li[(e / DT) * TLD + e % DT] = 0.0;
  for (int j0 = 0; j0 < W; j0 += DT) {
    const int nbj = min(DT, W - j0);
    const double* Ljj = L + (size_t)j0 * ldl + j0;
    dmma_stage<DT, TLD, TNT>(D, Ljj, ldl, nbj, nbj, 0, dmma_vec(Ljj, ldl));
    cp_async_commit();
    const double* Lj = L + (size_t)j0 * ldl;
    const int nk = j0 / DK;  // j0 is a multiple of 64
    auto stage = [&](int c) {
      const int s = c % DNS;
      dmma_stage<DK, DLD, TNT, RT>(As + s * ASTAGE, Xb, ldx, nr, j0, c * DK,
                                   vx);
      dmma_stage<DK, DLD, TNT>(Bs + s * DSTAGE, Lj, ldl, nbj, j0, c * DK,
                               vl);
    };
#pragma unroll
    for (int c = 0; c < DNS - 1; ++c) {
      if (c < nk) stage(c);
      cp_async_commit();
    }
    // this thread's cells of B_j, loaded while the copies are in flight
    double bj[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(0, e), c = frag_col(wc + 8 * j, e);
        bj[j][e] = r < nr && c < nbj ? Bb[(size_t)r * ldb + j0 + c] : 0.0;
      }
    cp_async_wait<DNS - 1>();  // L_jj has landed
    __syncthreads();
    for (int i = nbj + tid; i < DT; i += TNT) D[i * TLD + i] = 1.0;
    __syncthreads();
    tri_inv8_diag(D, Li);
    __syncthreads();
    tri_inv64_doubling(D, Li, P);
    // acc = X_{<j} L[j, <j]^T over this block's rows
    double acc[2][4] = {};
    for (int c = 0; c < nk; ++c) {
      cp_async_wait<DNS - 2>();
      __syncthreads();
      if (c + DNS - 1 < nk) stage(c + DNS - 1);
      cp_async_commit();
      const double* as = As + (c % DNS) * ASTAGE;
      const double* bs = Bs + (c % DNS) * DSTAGE;
#pragma unroll
      for (int k = 0; k < DK; k += 8) {
        double a[4], b[2];
        frag_a(a, as, DLD, 0, k);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          frag_bt(b, bs, DLD, wc + 8 * j, k);
          dmma(acc[j], a, b);
        }
      }
    }
    __syncthreads();  // the doubling is done with P, and Li is complete
    double* Ts = P;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Ts[frag_row(0, e) * TLD + frag_col(wc + 8 * j, e)] =
            bj[j][e] - acc[j][e];
    __syncthreads();
    // X_j = T Li^T; Li is zero past nbj, T is zero past nbj and nr
    double xo[2][4] = {};
#pragma unroll
    for (int k = 0; k < DT; k += 8) {
      double a[4], b[2];
      frag_a(a, Ts, TLD, 0, k);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        frag_bt(b, Li, TLD, wc + 8 * j, k);
        dmma(xo[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(0, e), c = frag_col(wc + 8 * j, e);
        if (r < nr && c < nbj) Xb[(size_t)r * ldx + j0 + c] = xo[j][e];
      }
    // the next step reads these columns back, and reuses D, T and the rings
    __syncthreads();
  }
}

}  // namespace

// B, X: (M, W); L: (W, W); fp64, rows contiguous, M, W >= 1.  Returns a
// cudaError_t code.
extern "C" int trsm_rlt_launch(const double* B, int ldb, const double* L,
                               int ldl, double* X, int ldx, int M, int W,
                               int device, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  CHECK(cudaSetDevice(device));
  static bool allowed[64];  // the dynamic shared memory, once per device
  if (!(device >= 0 && device < 64 && allowed[device])) {
    CHECK(cudaFuncSetAttribute(trsm_rlt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TRSM_SMEM));
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  trsm_rlt_kernel<<<(M + RT - 1) / RT, TNT, TRSM_SMEM, stream>>>(
      B, ldb, L, ldl, X, ldx, M, W);
  CHECK(cudaGetLastError());
  return 0;
}

extern "C" const char* trsm_rlt_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The library's kernel functions for the resource query (tile.cuh's
// func_attrs): out[5] for function i, its name in *name.
extern "C" int trsm_rlt_func_attrs(int i, int device, int* out,
                                   const char** name) {
  static const FuncInfo fs[] = {
      {(const void*)trsm_rlt_kernel, "trsm_rlt_kernel", TNT, TRSM_SMEM},
  };
  return func_attrs(fs, (int)(sizeof(fs) / sizeof(fs[0])), i, device, out,
                    name);
}
