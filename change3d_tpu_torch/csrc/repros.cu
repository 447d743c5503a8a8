// The two minimal Pallas repros, as CUDA kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of tests/manual_pallas_repros.py:
//   repro_dot_1d     (kernel at :26, pallas_call at :35)
//   repro_manual_dma (kernel at :40, pallas_call at :48)
// Each is the smallest case of a mechanism the fused X3D block relies on.
//
// dot_1d: y = bf16(bf16(mean_rows(x)) @ w) broadcast to every row of x; the
//   SE squeeze followed by a row-vector x matrix product
//   (change3d_tpu/ops/pallas/fused_block.py:59-67). One block of 1024
//   threads: fp32 column sums, each column split over threads by rows; the
//   row-vector product on CUDA cores, each output split over threads by
//   rows of w; both combined in a fixed order (no atomics, so reruns are
//   bit-identical); then a broadcast of the bf16 row with 16-byte stores.
//   Bound on the H100: bytes (x and w read once, the [R, N] output written
//   once; 160 KB at the repro's [256, 128] x [128, 128], 0.05 us at
//   3.35 TB/s), far below one launch, so the kernel is launch-bound; one
//   block is enough.
//
// manual_dma: out = 2 * x, x [N, R, C] fp32, one block per leading index as
//   the Pallas grid. Each block copies its [R, C] slab from global into
//   shared memory with one bulk TMA copy (cp.async.bulk) completed on an
//   mbarrier -- the counterpart of make_async_copy().start()/wait() -- then
//   writes 2 * x with 16-byte stores. Bound: bytes (x read once, out written
//   once; 512 KB at [4, 128, 128], 0.16 us), again below one launch.

#include "ptx.cuh"

namespace {

using c3d::from_f;
using c3d::to_f;

constexpr int kDotThreads = 1024;

// Shared memory of dot_1d: the bf16 result row, the C bf16 means (as fp32)
// and the partial sums of either phase.
__host__ __device__ inline int dot_1d_parts(int n) {
  return n < kDotThreads ? kDotThreads / n : 1;
}
__host__ __device__ inline int dot_1d_row_bytes(int N) { return (N * 2 + 15) / 16 * 16; }
inline int dot_1d_smem(int C, int N) {
  const int pc = dot_1d_parts(C) * C, pn = dot_1d_parts(N) * N;
  const int part = pc > pn ? pc : pn;
  return dot_1d_row_bytes(N) + (C + part) * (int)sizeof(float);
}

__global__ void __launch_bounds__(kDotThreads) dot_1d_kernel(const __nv_bfloat16* x,
                                                             const __nv_bfloat16* w,
                                                             __nv_bfloat16* out, int R, int C,
                                                             int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s = reinterpret_cast<float*>(smem + dot_1d_row_bytes(N));
  float* part = s + C;
  const int tid = threadIdx.x;

  // Column sums: thread j of a column sums rows j, j + p1, ...; then the p1
  // partials in order, one rounding of the mean (jnp.mean of bf16 sums in
  // fp32 and returns bf16).
  const int p1 = dot_1d_parts(C);
  for (int e = tid; e < p1 * C; e += kDotThreads) {
    const int c = e % C, j = e / C;
    float acc = 0.f;
    for (int r = j; r < R; r += p1) acc += to_f(x[(size_t)r * C + c]);
    part[j * C + c] = acc;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kDotThreads) {
    float acc = 0.f;
    for (int j = 0; j < p1; ++j) acc += part[j * C + c];
    s[c] = to_f(from_f<__nv_bfloat16>(acc / (float)R));
  }
  __syncthreads();

  // Row vector x matrix: thread j of an output takes the j-th run of rows of
  // w; the p2 partials add in order, one rounding.
  const int p2 = dot_1d_parts(N), run = (C + p2 - 1) / p2;
  for (int e = tid; e < p2 * N; e += kDotThreads) {
    const int n = e % N, j = e / N;
    float acc = 0.f;
    for (int c = j * run; c < min(C, (j + 1) * run); ++c)
      acc = fmaf(s[c], to_f(w[(size_t)c * N + n]), acc);
    part[j * N + n] = acc;
  }
  __syncthreads();
  for (int n = tid; n < N; n += kDotThreads) {
    float acc = 0.f;
    for (int j = 0; j < p2; ++j) acc += part[j * N + n];
    y[n] = from_f<__nv_bfloat16>(acc);
  }
  __syncthreads();

  // Broadcast to all R rows, 8 bf16 (16 bytes) per store.
  const int n8 = N / 8;
  const uint4* src = reinterpret_cast<const uint4*>(y);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int e = tid; e < R * n8; e += kDotThreads) dst[e] = src[e % n8];
}

__global__ void manual_dma_kernel(const float* x, float* out, int slab) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + 16);
  const size_t base = (size_t)blockIdx.x * slab;
  const uint32_t bytes = (uint32_t)slab * sizeof(float);

  if (threadIdx.x == 0) c3d::mbarrier_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {  // start(): one thread issues the whole slab's copy
    c3d::mbarrier_arrive_expect_tx(bar, bytes);
    c3d::bulk_copy_g2s(buf, x + base, bytes, bar);
  }
  c3d::mbarrier_wait(bar, 0);  // wait(): every thread, phase 0

  const float4* s = reinterpret_cast<const float4*>(buf);
  float4* o = reinterpret_cast<float4*>(out + base);
  for (int e = threadIdx.x; e < slab / 4; e += blockDim.x) {
    float4 v = s[e];
    v.x *= 2.f; v.y *= 2.f; v.z *= 2.f; v.w *= 2.f;
    o[e] = v;
  }
}

}  // namespace

// Shapes are checked by the Python wrappers (ops/repros.py): N % 8 == 0,
// (R * C) % 4 == 0, 16-byte aligned pointers. Return a cudaError_t.
extern "C" int c3d_dot_1d(const void* x, const void* w, void* out, int R, int C, int N,
                          void* stream) {
  const int smem = dot_1d_smem(C, N);
  cudaError_t err =
      cudaFuncSetAttribute(dot_1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dot_1d_kernel<<<1, kDotThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), R, C, N);
  return (int)cudaGetLastError();
}

extern "C" int c3d_manual_dma(const void* x, void* out, int N, int R, int C, void* stream) {
  const int slab = R * C;
  const int smem = 16 + slab * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(manual_dma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  manual_dma_kernel<<<N, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), slab);
  return (int)cudaGetLastError();
}

extern "C" const char* c3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
