// Fused X3D bottleneck res-block (inference) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of change3d_tpu/ops/pallas/fused_block.py:
//   fused_bottleneck_block         (_kernel)
//   fused_bottleneck_block_htiled  (_halo_body, _kernel_htiled, _kernel_se_sums)
//   fused_bottleneck_block_jtiled  (_jtile_front, _kernel_jtiled, _kernel_jtiled_se_sums)
// All three compute one function; here it is two kernels:
//
//   fused_block_fwd:     y = relu(BN_c(conv_c(swish(gate * BN_b(dw3x3x3(
//                            relu(BN_a(conv_a x))))))) + x)
//   fused_block_se_sums: per-(sample, tile) sums of BN_b(dw3x3x3(...)), the
//                        squeeze of the SE blocks; the gate FCs run in plain
//                        torch between the two launches (as the JAX code runs
//                        them outside its kernel). No atomics: each block
//                        writes its own row, so results are deterministic.
//
// Grid: (spatial tile, sample). A block owns a tile x tile pixel tile of all
// T frames, plus a 1-pixel halo in H and W (the Pallas kernels tile H only,
// because W fits whole in VMEM; 227 KB of shared memory does not hold a
// whole row band here). T stays whole and pads with zero frames. The inner
// channels Ci are walked in chunks of `ck`, accumulating conv_c in fp32, so
// the widest stage (Ci=432) fits too. Shared memory per block:
//   acc  float   [T*tile*tile][C]          conv_c accumulator (fwd only)
//   xa   float   [T*(tile+2)^2][ck]        conv_a+BN+ReLU chunk, rounded to scalar_t
//   xs   float   [T*tile*tile][ck]         swish chunk rounded to scalar_t (fwd),
//                                          or unrounded BN_b output (se_sums)
//   xt   scalar_t[T*(tile+2)^2][C]         the input tile with its halo
// ops/fused_block.py:plan_tiles picks tile and ck and passes the byte count.
//
// Rounding follows the Pallas kernel: xa rounds to the input dtype after
// conv_a+BN+ReLU (fused_block.py:45), the swish output rounds before conv_c
// (:69), the output rounds once at the store (:75). Out-of-image halo pixels
// are zeroed in xa-space, after conv_a+BN+ReLU (:112-117): conv_a+BN maps a
// zero pixel to relu(b_a) != 0.
//
// Bound on the H100: the block does 2*T*H*W*Ci*(2C+27) flops on 2*|x| bytes,
// far above the bf16 ridge for the two 1x1 convs, so the bound is the
// tensor-core rate for conv_a/conv_c (or the fp32 CUDA-core rate for the 27
// depthwise taps, whichever is larger). This first kernel computes both
// products with scalar fp32 FMAs on CUDA cores (no mma/wgmma, no TMA): it is
// right first, and recomputes conv_a on the halo ((tile+2)^2/tile^2). Moving
// conv_a/conv_c onto wgmma and staging tiles by TMA is the work that closes
// the gap to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// Round an fp32 value to the I/O dtype and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

struct Params {
  const void* x;      // [B,T,H,W,C] scalar_t
  void* out;          // [B,T,H,W,C] scalar_t (fwd)
  float* sums;        // [B,n_tiles,Ci] (se_sums)
  const void* w_a;    // [C,Ci] scalar_t
  const float* a_a;   // [Ci]
  const float* b_a;   // [Ci]
  const float* w_dw;  // [3,3,3,Ci]
  const float* a_b;   // [Ci]
  const float* b_b;   // [Ci]
  const float* gate;  // [B,Ci] or null
  const void* w_c;    // [Ci,C] scalar_t
  const float* a_c;   // [C]
  const float* b_c;   // [C]
  int T, H, W, C, Ci, tile, ck;
};

template <typename scalar_t, bool kSums>
__global__ void __launch_bounds__(kThreads) fused_block_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, H = p.H, W = p.W, C = p.C, Ci = p.Ci;
  const int tile = p.tile, ck = p.ck;
  const int hw = tile + 2;            // halo tile side
  const int n_halo = T * hw * hw;     // halo pixels (all frames)
  const int n_core = T * tile * tile; // output pixels (all frames)
  const int tiles_w = (W + tile - 1) / tile;
  const int tile_id = blockIdx.x;
  const int b = blockIdx.y;
  const int y0 = (tile_id / tiles_w) * tile;
  const int x0 = (tile_id % tiles_w) * tile;

  float* acc = reinterpret_cast<float*>(smem);
  float* xa = acc + (kSums ? 0 : n_core * C);
  float* xs = xa + n_halo * ck;
  scalar_t* xt = reinterpret_cast<scalar_t*>(xs + n_core * ck);

  const size_t sample = (size_t)T * H * W * C;
  const scalar_t* xg = static_cast<const scalar_t*>(p.x) + (size_t)b * sample;
  const scalar_t* wa = static_cast<const scalar_t*>(p.w_a);
  const scalar_t* wc = static_cast<const scalar_t*>(p.w_c);

  // Input tile with halo; pixels outside the image hold 0 (never used:
  // their xa is forced to 0 below, and they have no output).
  for (int e = threadIdx.x; e < n_halo * C; e += blockDim.x) {
    const int c = e % C, pos = e / C;
    const int xx = pos % hw, yy = (pos / hw) % hw, t = pos / (hw * hw);
    const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
    scalar_t v = from_f<scalar_t>(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xg[(((size_t)t * H + gy) * W + gx) * C + c];
    xt[e] = v;
  }
  if (!kSums)
    for (int e = threadIdx.x; e < n_core * C; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();

  for (int ci0 = 0; ci0 < Ci; ci0 += ck) {
    const int kc = min(ck, Ci - ci0);

    // conv_a (fp32 accumulate) -> BN_a -> ReLU -> round; 0 outside the image.
    for (int e = threadIdx.x; e < n_halo * kc; e += blockDim.x) {
      const int k = e % kc, pos = e / kc;
      const int xx = pos % hw, yy = (pos / hw) % hw;
      const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int ci = ci0 + k;
        const scalar_t* xr = xt + (size_t)pos * C;
        float s = 0.f;
        for (int c = 0; c < C; ++c) s = fmaf(to_f(xr[c]), to_f(wa[(size_t)c * Ci + ci]), s);
        v = round_to<scalar_t>(fmaxf(s * p.a_a[ci] + p.b_a[ci], 0.f));
      }
      xa[pos * ck + k] = v;
    }
    __syncthreads();

    // 27 depthwise taps in fp32 (T zero-padded) -> BN_b, then either the
    // squeeze input (se_sums) or gate -> swish -> round (fwd).
    for (int e = threadIdx.x; e < n_core * kc; e += blockDim.x) {
      const int k = e % kc, q = e / kc;
      const int tx = q % tile, ty = (q / tile) % tile, t = q / (tile * tile);
      const int ci = ci0 + k;
      float s = 0.f;
      for (int dt = 0; dt < 3; ++dt) {
        const int tt = t + dt - 1;
        if (tt < 0 || tt >= T) continue;
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx)
            s = fmaf(xa[((tt * hw + ty + dy) * hw + tx + dx) * ck + k],
                     p.w_dw[((dt * 3 + dy) * 3 + dx) * Ci + ci], s);
      }
      float xb = s * p.a_b[ci] + p.b_b[ci];
      if (kSums) {
        const bool inside = (y0 + ty) < H && (x0 + tx) < W;
        xs[q * ck + k] = inside ? xb : 0.f;
      } else {
        if (p.gate != nullptr) xb *= p.gate[(size_t)b * Ci + ci];
        xs[q * ck + k] = round_to<scalar_t>(xb / (1.f + expf(-xb)));
      }
    }
    __syncthreads();

    if (kSums) {
      // Fixed-order per-channel sums over the tile's pixels.
      const int n_tiles = gridDim.x;
      for (int k = threadIdx.x; k < kc; k += blockDim.x) {
        float s = 0.f;
        for (int q = 0; q < n_core; ++q) s += xs[q * ck + k];
        p.sums[((size_t)b * n_tiles + tile_id) * Ci + ci0 + k] = s;
      }
    } else {
      // conv_c partial product over this chunk, fp32 accumulate.
      for (int e = threadIdx.x; e < n_core * C; e += blockDim.x) {
        const int c = e % C, q = e / C;
        const float* xr = xs + q * ck;
        float s = acc[e];
        for (int k = 0; k < kc; ++k) s = fmaf(xr[k], to_f(wc[(size_t)(ci0 + k) * C + c]), s);
        acc[e] = s;
      }
    }
    __syncthreads();
  }

  if (!kSums) {
    // BN_c + residual (fp32) -> ReLU -> one rounding at the store.
    scalar_t* og = static_cast<scalar_t*>(p.out) + (size_t)b * sample;
    for (int e = threadIdx.x; e < n_core * C; e += blockDim.x) {
      const int c = e % C, q = e / C;
      const int tx = q % tile, ty = (q / tile) % tile, t = q / (tile * tile);
      const int gy = y0 + ty, gx = x0 + tx;
      if (gy >= H || gx >= W) continue;
      const float r = to_f(xt[((t * hw + ty + 1) * hw + tx + 1) * C + c]);
      const float y = fmaxf(acc[e] * p.a_c[c] + p.b_c[c] + r, 0.f);
      og[(((size_t)t * H + gy) * W + gx) * C + c] = from_f<scalar_t>(y);
    }
  }
}

template <typename scalar_t, bool kSums>
int launch(const Params& p, int B, int smem, void* stream) {
  auto kernel = fused_block_kernel<scalar_t, kSums>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((p.H + p.tile - 1) / p.tile) * ((p.W + p.tile - 1) / p.tile);
  dim3 grid(tiles, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* x, const void* w_a, const void* a_a, const void* b_a,
                   const void* w_dw, const void* a_b, const void* b_b, int T, int H, int W,
                   int C, int Ci, int tile, int ck) {
  Params p{};
  p.x = x;
  p.w_a = w_a;
  p.a_a = static_cast<const float*>(a_a);
  p.b_a = static_cast<const float*>(b_a);
  p.w_dw = static_cast<const float*>(w_dw);
  p.a_b = static_cast<const float*>(a_b);
  p.b_b = static_cast<const float*>(b_b);
  p.T = T; p.H = H; p.W = W; p.C = C; p.Ci = Ci; p.tile = tile; p.ck = ck;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int c3d_fused_block_fwd(int dtype, const void* x, void* out, const void* w_a,
                                   const void* a_a, const void* b_a, const void* w_dw,
                                   const void* a_b, const void* b_b, const void* gate,
                                   const void* w_c, const void* a_c, const void* b_c, int B,
                                   int T, int H, int W, int C, int Ci, int tile, int ck,
                                   int smem, void* stream) {
  Params p = make_params(x, w_a, a_a, b_a, w_dw, a_b, b_b, T, H, W, C, Ci, tile, ck);
  p.out = out;
  p.gate = static_cast<const float*>(gate);
  p.w_c = w_c;
  p.a_c = static_cast<const float*>(a_c);
  p.b_c = static_cast<const float*>(b_c);
  if (dtype == 1) return launch<__nv_bfloat16, false>(p, B, smem, stream);
  if (dtype == 0) return launch<float, false>(p, B, smem, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int c3d_fused_block_se_sums(int dtype, const void* x, void* sums, const void* w_a,
                                       const void* a_a, const void* b_a, const void* w_dw,
                                       const void* a_b, const void* b_b, int B, int T, int H,
                                       int W, int C, int Ci, int tile, int ck, int smem,
                                       void* stream) {
  Params p = make_params(x, w_a, a_a, b_a, w_dw, a_b, b_b, T, H, W, C, Ci, tile, ck);
  p.sums = static_cast<float*>(sums);
  if (dtype == 1) return launch<__nv_bfloat16, true>(p, B, smem, stream);
  if (dtype == 0) return launch<float, true>(p, B, smem, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* c3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
