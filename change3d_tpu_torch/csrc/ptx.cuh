// Small device helpers shared by the port's kernels (sm_90a): bf16 <-> fp32,
// 16-byte cp.async, bf16 tensor-core mma.sync, ldmatrix, mbarrier and bulk copies,
// cluster barriers and distributed shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Phase clocks. Built with -DC3D_PHASE_CLOCKS (tools/phase_clocks.py),
// C3D_PHASE(i) has thread 0 of each of the first 8 blocks of grid row 0
// record its SM's clock at mark i (< 16), and c3d_phase_clocks copies the
// [8][16] clocks to the host; otherwise C3D_PHASE is nothing.
#ifdef C3D_PHASE_CLOCKS
__device__ long long c3d_phase_clock[8][16];
#define C3D_PHASE(i)                                                                  \
  do {                                                                                \
    if (threadIdx.x == 0 && blockIdx.x < 8 && blockIdx.y == 0)                        \
      c3d_phase_clock[blockIdx.x][i] = clock64();                                     \
  } while (0)
extern "C" int c3d_phase_clocks(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, c3d_phase_clock, sizeof(c3d_phase_clock));
}
#else
#define C3D_PHASE(i) \
  do {               \
  } while (0)
#endif

namespace c3d {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two fp32 values rounded to bf16 and packed low|high, as a 32-bit word.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// 16-byte global -> shared copy that bypasses L1; completes at cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

// 4-byte global -> shared copy (through L1); completes at cp_async_wait_all.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// D += A * B, m16n8k16, bf16 operands, fp32 accumulate. a: 4 words of A
// (rows g and g+8, k pairs 2t and 2t+8), b: 2 words of B (column g, k pairs
// 2t and 2t+8), d: D[g][2t..2t+1], D[g+8][2t..2t+1]; g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix .trans: 8x8 b16 matrices from shared memory, transposed. Lane l
// gives the address of row l % 8 of matrix l / 8 (16 bytes, 16-byte
// aligned); r[i] gets matrix i's elements (2t, 2t+1) of column g (g = lane
// / 4, t = lane % 4). A [k][n] matrix's rows k0..k0+7 and k0+8..k0+15 at
// columns n0..n0+7 so give an m16n8k16 B fragment (b0, b1) of column n0 + g.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  // Make the initialised barrier visible to the async (bulk-copy) proxy.
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Bulk (TMA, non-tensor) copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory; completion is counted on
// the mbarrier as transaction bytes.
__device__ __forceinline__ void bulk_copy_g2s(void* smem, const void* gmem, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread block clusters. The rank of this block in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, split: arrive (release: this block's shared-memory
// writes become visible to the cluster) and wait (acquire). Every thread of
// every block in the cluster calls both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// An arrive that orders none of this thread's memory accesses for the
// others: for a block that only signals it is done reading theirs.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// p, a variable in this block's shared memory, as the address of the same
// variable in block `rank` of the cluster (distributed shared memory).
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

}  // namespace c3d
