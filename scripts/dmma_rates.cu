// Issue rate and fragment layout of the fp64 mma.sync shapes on Hopper.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -o dmma_rates \
//        scripts/dmma_rates.cu && ./dmma_rates
//
// Each shape runs from registers in 528 blocks of 4 warps (8 independent
// accumulators a thread), and the TFLOP/s of each is printed; then one warp
// computes a 16 x 8 product with K = 16 through m16n8k4, m16n8k8 and
// m16n8k16 with the fragment layouts the port's tile uses (tile.cuh), and
// the largest difference from the host's product is printed.
#include <cstdio>
#include <cuda_runtime.h>
#include <cmath>
__device__ __forceinline__ void m884(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1},{%2},{%3},{%0,%1};" : "+d"(c[0]), "+d"(c[1]) : "d"(a), "d"(b));
}
__device__ __forceinline__ void m1684(double (&c)[4], const double (&a)[2], double b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5},{%6},{%0,%1,%2,%3};" : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b));
}
__device__ __forceinline__ void m1688(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};" : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void m16816(double (&c)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7,%8,%9,%10,%11},{%12,%13,%14,%15},{%0,%1,%2,%3};" : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
template <int S> __global__ void thr(double* out, int iters) {
  double acc[8][4] = {};
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (S == 0) { double c2[2] = {acc[j][0], acc[j][1]}; m884(c2, a[0], b[0]); m884(c2, a[1], b[1]); acc[j][0]=c2[0]; acc[j][1]=c2[1]; }
      if (S == 1) { m1684(acc[j], *(const double(*)[2])a, b[0]); }
      if (S == 2) { m1688(acc[j], *(const double(*)[4])a, *(const double(*)[2])b); }
      if (S == 3) { m16816(acc[j], a, b); }
    }
  }
  double s = 0; for (int j = 0; j < 8; ++j) for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// layout check: one warp, A 16xK row-major, B 8xK row-major (N x K), C = A B^T 16x8
template <int S> __global__ void lay(const double* A, const double* B, double* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int K = 16;
  double c[4] = {0, 0, 0, 0};
  if (S == 1) for (int k = 0; k < K; k += 4) { double a[2] = {A[g*K+k+t], A[(g+8)*K+k+t]}; m1684(c, a, B[g*K+k+t]); }
  if (S == 2) for (int k = 0; k < K; k += 8) { double a[4] = {A[g*K+k+t], A[(g+8)*K+k+t], A[g*K+k+t+4], A[(g+8)*K+k+t+4]}; double b[2] = {B[g*K+k+t], B[g*K+k+t+4]}; m1688(c, a, b); }
  if (S == 3) { double a[8], b[4]; for (int i = 0; i < 4; ++i) { a[2*i] = A[g*K+t+4*i]; a[2*i+1] = A[(g+8)*K+t+4*i]; b[i] = B[g*K+t+4*i]; } m16816(c, a, b); }
  C[g*8 + 2*t] = c[0]; C[g*8 + 2*t + 1] = c[1]; C[(g+8)*8 + 2*t] = c[2]; C[(g+8)*8 + 2*t + 1] = c[3];
}
int main() {
  double *out; cudaMalloc(&out, 132*4*128*8);
  const int iters = 4096;
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  const char* names[4] = {"m8n8k4(x2)", "m16n8k4", "m16n8k8", "m16n8k16"};
  const double fl[4] = {2*2*8*8*4, 2*16*8*4, 2*16*8*8, 2*16*8*16};
  for (int S = 0; S < 4; ++S) for (int rep = 0; rep < 2; ++rep) {
    void (*k)(double*, int) = S==0 ? thr<0> : S==1 ? thr<1> : S==2 ? thr<2> : thr<3>;
    k<<<132*4, 128>>>(out, 16); cudaDeviceSynchronize();
    cudaEventRecord(e0); k<<<132*4, 128>>>(out, iters); cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    double flops = fl[S] * 8.0 * iters * (132*4*4);
    printf("%s: %.3f ms, %.1f TFLOP/s\n", names[S], ms, flops / ms / 1e9);
  }
  double hA[16*16], hB[8*16], hC[128], ref[128];
  for (int i = 0; i < 256; ++i) hA[i] = sin(1.0 + i * 0.7);
  for (int i = 0; i < 128; ++i) hB[i] = cos(2.0 + i * 1.3);
  for (int r = 0; r < 16; ++r) for (int c = 0; c < 8; ++c) { double s = 0; for (int k = 0; k < 16; ++k) s += hA[r*16+k]*hB[c*16+k]; ref[r*8+c] = s; }
  double *dA, *dB, *dC; cudaMalloc(&dA, sizeof hA); cudaMalloc(&dB, sizeof hB); cudaMalloc(&dC, sizeof hC);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice); cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  for (int S = 1; S < 4; ++S) {
    cudaMemset(dC, 0, sizeof hC);
    if (S == 1) lay<1><<<1, 32>>>(dA, dB, dC); if (S == 2) lay<2><<<1, 32>>>(dA, dB, dC); if (S == 3) lay<3><<<1, 32>>>(dA, dB, dC);
    cudaMemcpy(hC, dC, sizeof hC, cudaMemcpyDeviceToHost);
    double err = 0; for (int i = 0; i < 128; ++i) err = fmax(err, fabs(hC[i] - ref[i]));
    printf("layout %s: max err %.3e (%s)\n", names[S], err, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
