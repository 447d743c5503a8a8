// The two minimal Pallas repros, as CUDA kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of tests/manual_pallas_repros.py:
//   repro_dot_1d     (kernel at :26, pallas_call at :35)
//   repro_manual_dma (kernel at :40, pallas_call at :48)
// Each is the smallest case of a mechanism the fused X3D block relies on.
//
// dot_1d: y = bf16(bf16(mean_rows(x)) @ w) broadcast to every row of x; the
//   SE squeeze followed by a row-vector x matrix product
//   (change3d_tpu/ops/pallas/fused_block.py:59-67).
//   Bound on the H100: bytes (x and w read once, the [R, N] output written
//   once; 160 KB at the repro's [256, 128] x [128, 128], 0.05 us at
//   3.35 TB/s), far below one launch: the kernel is bound by its chain of
//   latencies, not by bytes or operations.
//   Design: one cluster of 8 blocks (CTAs) of 256 threads on 8 SMs, which
//   cuts the chain and spreads the reads. Block k owns rows
//   [k * ceil(R/8), ...) of x and of the output (a block with no rows still
//   takes part in both cluster barriers). Each block first starts one bulk
//   copy of all of w into its shared memory (on an mbarrier; after the
//   first block it comes from L2), then sums its rows of x into fp32 column
//   partials with 16-byte loads, up to four rows in flight per thread, and
//   reduces them in a fixed order. After a cluster barrier every block adds
//   the 8 partials from distributed shared memory in rank order 0..7, so all
//   blocks form bit-identical sums and the same bf16 mean, and reruns are
//   bit-identical (no atomics). Every block then computes the whole row
//   s @ w from its shared w (each warp one eighth of C, each lane 4 columns
//   by 8-byte loads, the warps added in order) rather than exchange y a
//   second time, and writes it to its own rows with 16-byte stores. A
//   second cluster barrier, split around the product (a relaxed arrive
//   once the partials are read, the wait at the end), keeps each block's
//   partials alive until every block has read them. The C3D_PHASE marks
//   let tools/phase_clocks.py read where the cycles go.
//
// manual_dma: out = 2 * x, x [N, R, C] fp32. Each [R, C] slab is cut into
//   chunks of a multiple of 16 bytes (the last one of a slab may be shorter)
//   so that about one wave of blocks covers the card (ops/repros.py
//   manual_dma_plan: 128 blocks of one 2 KB chunk at [4, 128, 128]). As in
//   the Pallas repro, each chunk goes global -> shared by one bulk TMA copy
//   (cp.async.bulk) that one thread issues and every thread waits for on an
//   mbarrier -- make_async_copy().start()/wait() -- then the block writes
//   2 * x with one 16-byte store per thread per 2 KB. A block that owns
//   several consecutive chunks keeps two buffers and two barriers: chunk
//   k + 1's copy is in flight while chunk k is written, each barrier's wait
//   parity flips on every reuse, and a __syncthreads() ends each chunk so
//   that no copy refills a buffer that a thread still reads. Shared memory
//   is one or two chunks, so a slab of any size is taken. Bound: bytes (x
//   read once, out written once; 512 KB at [4, 128, 128], 0.16 us).
//
// Host side: each kernel's dynamic shared-memory limit is raised to the
// card's opt-in maximum once per process and device, not on every launch.

#include <atomic>

#include "ptx.cuh"

namespace {

using c3d::from_f;

constexpr int kDotRanks = 8;  // blocks in the cluster (the portable maximum)
constexpr int kDotThreads = 256;
constexpr int kDotWarps = kDotThreads / 32;
constexpr int kDmaThreads = 128;

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Threads that share one group of 8 columns in dot_1d's column sums, each
// taking every lanes-th row of the block's rows.
__host__ __device__ inline int dot_1d_lanes(int C) {
  return C / 8 < kDotThreads ? kDotThreads / (C / 8) : 1;
}

// Byte offsets of dot_1d's shared memory: the mbarrier, w [C, N] bf16, the
// block's column partials [C] and the bf16 mean [C] (fp32), fp32 scratch
// for the per-lane column sums [lanes, C] and later the per-warp products
// [8, N], the bf16 row y [N]. ops/repros.py dot_1d_smem mirrors `total`.
struct DotLayout {
  int w, part, s, scratch, y, total;
};

__host__ __device__ inline DotLayout dot_1d_layout(int C, int N) {
  DotLayout l;
  l.w = 16;
  l.part = l.w + round16(C * N * 2);
  l.s = l.part + C * 4;
  l.scratch = l.s + C * 4;
  const int lanes_c = dot_1d_lanes(C) * C, warps_n = kDotWarps * N;
  l.y = l.scratch + 4 * (lanes_c > warps_n ? lanes_c : warps_n);
  l.total = l.y + round16(N * 2);
  return l;
}

__device__ __forceinline__ void add_bf16x8(float (&acc)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = c3d::unpack_bf16x2(w[k]);
    acc[2 * k] += f.x;
    acc[2 * k + 1] += f.y;
  }
}

__device__ __forceinline__ void store_f32x8(float* dst, const float (&acc)[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

__global__ void __cluster_dims__(kDotRanks, 1, 1) __launch_bounds__(kDotThreads)
    dot_1d_kernel(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* out, int R,
                  int C, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DotLayout l = dot_1d_layout(C, N);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const uint2* w4 = reinterpret_cast<const uint2*>(smem + l.w);  // 4 bf16 per word
  float* part = reinterpret_cast<float*>(smem + l.part);
  float* s = reinterpret_cast<float*>(smem + l.s);
  float* scratch = reinterpret_cast<float*>(smem + l.scratch);
  __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(smem + l.y);
  const int tid = threadIdx.x;
  const int per_rank = (R + kDotRanks - 1) / kDotRanks;
  const int row0 = min(R, (int)c3d::cluster_rank() * per_rank), row1 = min(R, row0 + per_rank);
  C3D_PHASE(0);

  // All of w into shared memory by one bulk copy; it lands while x is summed.
  if (tid == 0) {
    const uint32_t bytes = (uint32_t)C * N * 2;
    c3d::mbarrier_init(bar, 1);
    c3d::mbarrier_arrive_expect_tx(bar, bytes);
    c3d::bulk_copy_g2s(smem + l.w, w, bytes, bar);
  }

  // Column sums of this block's rows: thread (j, g) adds columns 8g..8g+7 of
  // rows row0 + j, row0 + j + lanes, ..., up to four 16-byte loads in flight.
  const int groups = C / 8, lanes = dot_1d_lanes(C);
  const uint4* x16 = reinterpret_cast<const uint4*>(x);
  for (int e = tid; e < lanes * groups; e += kDotThreads) {
    const int g = e % groups, j = e / groups;
    float acc[8] = {};
    for (int r = row0 + j; r < row1; r += 4 * lanes) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r + u * lanes < row1) v[u] = __ldg(x16 + (size_t)(r + u * lanes) * groups + g);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r + u * lanes < row1) add_bf16x8(acc, v[u]);
    }
    store_f32x8(scratch + j * C + g * 8, acc);
  }
  C3D_PHASE(1);
  __syncthreads();
  for (int c = tid; c < C; c += kDotThreads) {  // the lanes in order
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < lanes; ++j) acc += scratch[j * C + c];
    part[c] = acc;
  }

  // Every block's partials, from distributed shared memory in rank order,
  // then one rounding of the mean (jnp.mean of bf16 sums in fp32, returns
  // bf16).
  C3D_PHASE(2);
  c3d::cluster_arrive();
  c3d::cluster_wait();
  C3D_PHASE(3);
  for (int c = tid; c < C; c += kDotThreads) {
    float v[kDotRanks];  // all 8 remote loads in flight, then the sum in rank order
#pragma unroll
    for (int k = 0; k < kDotRanks; ++k) v[k] = c3d::ld_cluster_f32(c3d::cluster_map(part + c, k));
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kDotRanks; ++k) acc += v[k];
    s[c] = c3d::round_to<__nv_bfloat16>(acc / (float)R);
  }
  // Done with the other blocks' partials (their values are in s, stored
  // before this arrive): arrive now, wait at the end. Relaxed, as this block
  // publishes nothing to the others, so no release has to be waited for.
  C3D_PHASE(4);
  c3d::cluster_arrive_relaxed();
  c3d::mbarrier_wait(bar, 0);
  C3D_PHASE(5);
  __syncthreads();

  // y = s @ w: warp k takes rows [k C/8, (k+1) C/8) of w, each lane 4
  // columns at a time (8-byte loads); the 8 warp partials add in order, one
  // rounding.
  const int warp = tid / 32, lane = tid % 32, cw = C / kDotWarps, n4 = N / 4;
  for (int q = lane; q < n4; q += 32) {
    float a[4] = {};
#pragma unroll 8
    for (int c = warp * cw; c < (warp + 1) * cw; ++c) {
      const uint2 v = w4[c * n4 + q];
      const float sc = s[c];
      const float2 lo = c3d::unpack_bf16x2(v.x), hi = c3d::unpack_bf16x2(v.y);
      a[0] = fmaf(sc, lo.x, a[0]);
      a[1] = fmaf(sc, lo.y, a[1]);
      a[2] = fmaf(sc, hi.x, a[2]);
      a[3] = fmaf(sc, hi.y, a[3]);
    }
    reinterpret_cast<float4*>(scratch + warp * N)[q] = make_float4(a[0], a[1], a[2], a[3]);
  }
  __syncthreads();
  for (int n = tid; n < N; n += kDotThreads) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kDotWarps; ++k) acc += scratch[k * N + n];
    y[n] = from_f<__nv_bfloat16>(acc);
  }
  __syncthreads();
  C3D_PHASE(6);

  // y to this block's rows, 8 bf16 (16 bytes) per store.
  const int n8 = N / 8;
  const uint4* src = reinterpret_cast<const uint4*>(y);
  uint4* dst = reinterpret_cast<uint4*>(out) + (size_t)row0 * n8;
  for (int e = tid; e < (row1 - row0) * n8; e += kDotThreads) dst[e] = src[e % n8];
  C3D_PHASE(7);
  c3d::cluster_wait();  // no block leaves while another may still read its partials
  C3D_PHASE(8);
}

// Block b copies chunks [b * per_block, ...) of the N * per_slab chunks;
// chunk j is elements [(j % per_slab) * chunk, ...) of slab j / per_slab.
__global__ void __launch_bounds__(kDmaThreads)
    manual_dma_kernel(const float* x, float* out, int slab, int chunk, int per_slab, int chunks,
                      int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // one per buffer
  float* buf = reinterpret_cast<float*>(smem + 16);   // one or two chunks
  const int first = blockIdx.x * per_block, last = min(chunks, first + per_block);
  C3D_PHASE(0);

  // start(): one thread posts chunk j's bytes on buffer b's barrier and
  // issues its bulk copy.
  auto start = [&](int j, int b) {
    const int off = (j % per_slab) * chunk;
    const uint32_t bytes = (uint32_t)min(chunk, slab - off) * sizeof(float);
    c3d::mbarrier_arrive_expect_tx(bar + b, bytes);
    c3d::bulk_copy_g2s(buf + (size_t)b * chunk, x + (size_t)(j / per_slab) * slab + off, bytes,
                       bar + b);
  };
  if (threadIdx.x == 0) {
    c3d::mbarrier_init(bar, 1);
    c3d::mbarrier_init(bar + 1, 1);
    start(first, 0);
  }
  __syncthreads();  // the barriers are initialised before any thread waits
  C3D_PHASE(1);

  for (int j = first; j < last; ++j) {
    const int k = j - first, b = k & 1;
    // The other buffer was last read in iteration k - 1, which every thread
    // has left (the __syncthreads below), so its refill may start.
    if (threadIdx.x == 0 && j + 1 < last) start(j + 1, b ^ 1);
    c3d::mbarrier_wait(bar + b, (k >> 1) & 1);  // wait(): buffer b's (k/2)-th fill
    if (k == 0) C3D_PHASE(2);
    const int off = (j % per_slab) * chunk, n4 = min(chunk, slab - off) / 4;
    const float4* s = reinterpret_cast<const float4*>(buf + (size_t)b * chunk);
    float4* o = reinterpret_cast<float4*>(out + (size_t)(j / per_slab) * slab + off);
    for (int e = threadIdx.x; e < n4; e += kDmaThreads) {
      float4 v = s[e];
      v.x *= 2.f;
      v.y *= 2.f;
      v.z *= 2.f;
      v.w *= 2.f;
      o[e] = v;
    }
    __syncthreads();
  }
  C3D_PHASE(3);
}

// Let both kernels take the card's opt-in shared memory per block (227 KB
// on the H100); once per process and device.
cudaError_t allow_opt_in_smem() {
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (ready.load() & bit) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dot_1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(manual_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

}  // namespace

// Shapes are checked by the Python wrappers (ops/repros.py): C % 8 == 0,
// N % 8 == 0, (R * C) % 4 == 0, 16-byte aligned pointers; manual_dma's
// chunk, per_slab, per_block and grid come from manual_dma_plan. Return a
// cudaError_t (a refused launch or cluster included).
extern "C" int c3d_dot_1d(const void* x, const void* w, void* out, int R, int C, int N,
                          void* stream) {
  cudaError_t err = allow_opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  dot_1d_kernel<<<kDotRanks, kDotThreads, dot_1d_layout(C, N).total,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<const __nv_bfloat16*>(x),
                                                       static_cast<const __nv_bfloat16*>(w),
                                                       static_cast<__nv_bfloat16*>(out), R, C, N);
  return (int)cudaGetLastError();
}

extern "C" int c3d_manual_dma(const void* x, void* out, int N, int R, int C, int chunk,
                              int per_slab, int per_block, int grid, void* stream) {
  cudaError_t err = allow_opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  const int smem = 16 + (per_block > 1 ? 2 : 1) * chunk * (int)sizeof(float);
  manual_dma_kernel<<<grid, kDmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), R * C, chunk, per_slab,
      N * per_slab, per_block);
  return (int)cudaGetLastError();
}

extern "C" const char* c3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
