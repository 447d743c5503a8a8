// Depthwise (channelwise) 3D convolution on channels-last activations, for
// Hopper (sm_90a), inference only (no backward).
//
//   out[b, t', y', x', c] = round(sum_{dt, dy, dx} round(w[c, dt, dy, dx]) *
//                                 x[b, t'*st - pt + dt, y'*sh - ph + dy, x'*sw - pw + dx, c])
//
// with zeros outside the clip, round() a cast to the activation dtype, the
// products and their sum in fp32 (fmaf on CUDA cores, never TF32) and one
// rounding at the store: the numerics of conv3d(groups=C) with the weights
// cast to the activation dtype, as the JAX op (lax.conv_general_dilated with
// feature_group_count=C) and the port's plain version compute it.
//
// Replaces no Pallas kernel: on the TPU the op is an XLA conv
// (change3d_tpu/ops/layers.py:depthwise_conv3d). On the H100, cuDNN runs a
// grouped conv3d on [B, C, T, H, W] as one launch per channel, each with a
// layout conversion, around 120x its bytes bound at X3D-L's stem and strided
// block-0 shapes. This kernel takes the port's [B, T, H, W, C] layout as it
// is, in one launch.
//
// What bounds it on the H100: ~2 flops per tap against 2-4 bytes per
// element in and out, so bytes at 3.35 TB/s. The design moves each input
// byte from HBM about once:
//   - a block owns tt output frames x an oh x ow tile of output pixels x cc
//     channels (ops/depthwise_conv.py:plan_depthwise picks them, so that a
//     block holds at most 512 threads and 100 KB of shared memory: two or
//     more blocks per SM, one loading while another computes);
//   - it stages its input tile, the halo included (rows (oh-1)*sh + kh,
//     columns (ow-1)*sw + kw, the frames its outputs read, clipped to the
//     clip), into shared memory by cp.async. Where the block takes every
//     channel, each tile row is one contiguous run of bytes, copied in
//     16-byte pieces into a shared-memory row placed at the same address
//     modulo 16 (so a C of 54 bf16, 108 bytes a pixel, still copies 16 bytes
//     at a time); otherwise each pixel's cc channels are copied in pieces of
//     the thread's vector (16 bytes where C allows). Halo bytes that
//     neighbouring blocks also read come from L2;
//   - the taps' weights for the block's channels, rounded to the activation
//     dtype and kept as fp32, sit in shared memory beside the tile;
//   - a thread owns one output pixel and a vector of VEC channels (16 bytes
//     where C allows: 8 bf16 or 4 fp32; else 8, 4 or 2 bytes), loops over the
//     tt output frames with VEC fp32 accumulators in registers, and skips
//     the taps that fall outside the clip (so nothing outside is staged or
//     zeroed). Loads from shared memory and the store are one vector each.
// kh = kw = 1 (X3D's 5x1x1 stem conv) has no halo: each input byte is
// staged once and read by the kt outputs that use it. 3x3 and 1x1 spatial
// kernels are unrolled at compile time; any other size loops at run time.

#include <algorithm>

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;

struct Params {
  const void* x;    // [B, T, H, W, C] scalar_t, contiguous, 16-byte aligned
  const float* w;   // [C, kt, kh, kw] fp32
  void* out;        // [B, To, Ho, Wo, C] scalar_t
  int B, T, H, W, C;
  int To, Ho, Wo;
  int kt, kh, kw, st, sh, sw, pt, ph, pw;
  int tt, oh, ow, cc;           // the plan: output frames, rows, columns, channels per block
  int nf, ih, iw, row_bytes;    // the staged tile: frames, rows, columns; bytes per row
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Bytes of one staged row: iw pixels of cc channels, rounded up to 16, and 16
// more for the row's offset modulo 16 (the contiguous copy's alignment).
__host__ __device__ __forceinline__ int row_bytes(int iw, int cc, int es) {
  return ceil_div(iw * cc * es, 16) * 16 + 16;
}

// N-byte global -> shared copy (N = 4, 8 or 16); `bytes` < N reads only the
// first `bytes` bytes and zero-fills the rest.
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes = N) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(c3d::smem_addr(smem)),
                 "l"(gmem), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(c3d::smem_addr(smem)),
                 "l"(gmem), "n"(N), "r"(bytes)
                 : "memory");
  }
}

// VEC consecutive elements as fp32, by one load of VEC * sizeof(T) bytes.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const void* p, float (&v)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC == 4) {
      const float4 q = *static_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if constexpr (VEC == 2) {
      const float2 q = *static_cast<const float2*>(p);
      v[0] = q.x; v[1] = q.y;
    } else {
      v[0] = *static_cast<const float*>(p);
    }
  } else {
    if constexpr (VEC == 8) {
      const uint4 q = *static_cast<const uint4*>(p);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = c3d::unpack_bf16x2(w[i]);
        v[2 * i] = f.x; v[2 * i + 1] = f.y;
      }
    } else if constexpr (VEC == 4) {
      const uint2 q = *static_cast<const uint2*>(p);
      const float2 a = c3d::unpack_bf16x2(q.x), b = c3d::unpack_bf16x2(q.y);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else if constexpr (VEC == 2) {
      const float2 f = c3d::unpack_bf16x2(*static_cast<const uint32_t*>(p));
      v[0] = f.x; v[1] = f.y;
    } else {
      v[0] = __bfloat162float(*static_cast<const bf16*>(p));
    }
  }
}

// VEC fp32 values rounded to T once and stored by one store.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(void* p, const float (&v)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC == 4) {
      *static_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VEC == 2) {
      *static_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *static_cast<float*>(p) = v[0];
    }
  } else {
    if constexpr (VEC == 8) {
      *static_cast<uint4*>(p) =
          make_uint4(c3d::pack_bf16x2(v[0], v[1]), c3d::pack_bf16x2(v[2], v[3]),
                     c3d::pack_bf16x2(v[4], v[5]), c3d::pack_bf16x2(v[6], v[7]));
    } else if constexpr (VEC == 4) {
      *static_cast<uint2*>(p) =
          make_uint2(c3d::pack_bf16x2(v[0], v[1]), c3d::pack_bf16x2(v[2], v[3]));
    } else if constexpr (VEC == 2) {
      *static_cast<uint32_t*>(p) = c3d::pack_bf16x2(v[0], v[1]);
    } else {
      *static_cast<bf16*>(p) = __float2bfloat16_rn(v[0]);
    }
  }
}

// VEC fp32 weights (VEC * 4 bytes, aligned to min(16, VEC * 4)).
template <int VEC>
__device__ __forceinline__ void load_w(const float* p, float (&v)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

// Grid: (blocks per sample, B). A block's index runs over the output pixel
// tiles (row-major), then the T-tiles, then the channel chunks. KS is kh = kw
// when known at compile time (1 or 3), 0 for any other size.
template <typename T, int VEC, int KS>
__global__ void __launch_bounds__(kMaxThreads, 2) depthwise_conv3d_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ES = sizeof(T);
  const int kh = KS ? KS : p.kh, kw = KS ? KS : p.kw;
  const int b = blockIdx.y;
  int id = blockIdx.x;
  const int tiles_w = ceil_div(p.Wo, p.ow), tiles_h = ceil_div(p.Ho, p.oh);
  const int n_tt = ceil_div(p.To, p.tt);
  const int x0 = (id % tiles_w) * p.ow;
  id /= tiles_w;
  const int y0 = (id % tiles_h) * p.oh;
  id /= tiles_h;
  const int t0 = (id % n_tt) * p.tt;
  const int c0 = (id / n_tt) * p.cc;
  const int ccb = min(p.cc, p.C - c0);  // this block's channels (the last chunk may be short)
  const int pb = ccb * ES;              // staged bytes per pixel

  // The staged tile: frames [fa, fb), rows [ya, yb), columns [xa, xb) of the
  // clip, at frame slot f - fa, row slot y - y_first, column slot x - x_first.
  const int t_end = min(t0 + p.tt, p.To), y_end = min(y0 + p.oh, p.Ho);
  const int x_end = min(x0 + p.ow, p.Wo);
  const int f_first = t0 * p.st - p.pt, y_first = y0 * p.sh - p.ph, x_first = x0 * p.sw - p.pw;
  const int fa = max(f_first, 0), fb = min((t_end - 1) * p.st - p.pt + p.kt, p.T);
  const int ya = max(y_first, 0), yb = min((y_end - 1) * p.sh - p.ph + kh, p.H);
  const int xa = max(x_first, 0), xb = min((x_end - 1) * p.sw - p.pw + kw, p.W);
  const int taps = p.kt * kh * kw;
  float* ws = reinterpret_cast<float*>(smem + p.nf * p.ih * p.row_bytes);
  const char* xg = static_cast<const char*>(p.x);
  const long long total = (long long)p.B * p.T * p.H * p.W * p.C * ES;
  const int nr = yb - ya, nrows = (fb - fa) * nr;

  if (nrows > 0 && xb > xa) {
    if (ccb == p.C) {
      // Every channel: a row of the tile is the bytes [ga, gb) of x, copied
      // by 16-byte pieces from ga rounded down to 16. Byte g of x lands at
      // row + (g - 16 * floor(g_first / 16)), where g_first is the byte
      // offset of pixel x_first (negative left of the image): the row keeps
      // x's alignment modulo 16. Pieces that run into neighbouring pixels
      // land on column slots no tap reads.
      const int per_row = p.row_bytes / 16;
      for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
        const int r = i / per_row, k = i % per_row;
        const int f = fa + r / nr, y = ya + r % nr;
        const long long pix0 = ((long long)(b * p.T + f) * p.H + y) * p.W;  // pixel (b, f, y, 0)
        const long long ga = (pix0 + xa) * p.C * ES, gb = (pix0 + xb) * p.C * ES;
        const long long g_first = (pix0 + x_first) * p.C * ES;
        const long long g = (ga & ~15LL) + 16LL * k;
        if (g >= gb) continue;
        unsigned char* dst = smem + ((f - fa) * p.ih + (y - y_first)) * p.row_bytes +
                             (g - (g_first & ~15LL));
        cp_async<16>(dst, xg + g, total - g < 16 ? (int)(total - g) : 16);
      }
    } else if constexpr (VEC * ES >= 4) {
      // A chunk of channels: each pixel's ccb channels by pieces of the
      // thread's vector (16 bytes where C allows; pieces never straddle a
      // pixel, every offset is a multiple of the piece). The launch refuses
      // chunks of 2-byte vectors (bf16 with an odd C), which cp.async cannot
      // copy.
      constexpr int PIECE = VEC * ES;
      const int per_px = pb / PIECE, per_row = (xb - xa) * per_px;
      for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
        const int r = i / per_row, k = i % per_row;
        const int f = fa + r / nr, y = ya + r % nr;
        const int px = xa + k / per_px, part = k % per_px;
        const long long pix = ((long long)(b * p.T + f) * p.H + y) * p.W + px;
        unsigned char* dst = smem + ((f - fa) * p.ih + (y - y_first)) * p.row_bytes +
                             (px - x_first) * pb + part * PIECE;
        cp_async<PIECE>(dst, xg + (pix * p.C + c0) * ES + part * PIECE);
      }
    }
  }
  // The block's weights, [tap][cc], rounded to T.
  for (int i = threadIdx.x; i < taps * ccb; i += blockDim.x) {
    const int tap = i / ccb, c = i % ccb;
    ws[tap * p.cc + c] = c3d::round_to<T>(p.w[(size_t)(c0 + c) * taps + tap]);
  }
  c3d::cp_async_wait_all();
  __syncthreads();

  // One output pixel and VEC channels per thread.
  const int nv = p.cc / VEC;
  const int col = threadIdx.x / nv, cl = (threadIdx.x % nv) * VEC;
  const int oy = y0 + col / p.ow, ox = x0 + col % p.ow;
  if (col >= p.oh * p.ow || oy >= p.Ho || ox >= p.Wo || cl >= ccb) return;
  const int iy0 = oy * p.sh - p.ph, ix0 = ox * p.sw - p.pw;
  const int dy0 = max(0, -iy0), dy1 = min(kh, p.H - iy0);
  const int dx0 = max(0, -ix0), dx1 = min(kw, p.W - ix0);
  // Where pixel x_first of row (f, y) sits in its staged row: the
  // contiguous copy's g_first modulo 16 (32-bit products wrap modulo 2^32, a
  // multiple of 16, so the residue is exact); 0 for a chunk of channels.
  const bool contiguous = ccb == p.C;
  auto row_of = [&](int f, int y) -> const unsigned char* {
    const uint32_t pix =
        ((uint32_t)(b * p.T + f) * (uint32_t)p.H + (uint32_t)y) * (uint32_t)p.W + (uint32_t)x_first;
    const uint32_t shift = contiguous ? (pix * (uint32_t)p.C * (uint32_t)ES) & 15u : 0u;
    return smem + ((f - fa) * p.ih + (y - y_first)) * p.row_bytes + shift +
           (ix0 - x_first) * pb + cl * ES;
  };
  T* out = static_cast<T*>(p.out);
  for (int to = t0; to < t_end; ++to) {
    const int if0 = to * p.st - p.pt;
    const int dt0 = max(0, -if0), dt1 = min(p.kt, p.T - if0);
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int dt = dt0; dt < dt1; ++dt) {
      const int f = if0 + dt;
      if constexpr (KS != 0) {
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          if (dy < dy0 || dy >= dy1) continue;
          const unsigned char* row = row_of(f, iy0 + dy);
          const float* wrow = ws + ((dt * KS + dy) * KS) * p.cc + cl;
#pragma unroll
          for (int dx = 0; dx < KS; ++dx) {
            if (dx < dx0 || dx >= dx1) continue;
            float xv[VEC], wv[VEC];
            load_vec<T, VEC>(row + dx * pb, xv);
            load_w<VEC>(wrow + dx * p.cc, wv);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = fmaf(xv[j], wv[j], acc[j]);
          }
        }
      } else {
        for (int dy = dy0; dy < dy1; ++dy) {
          const unsigned char* row = row_of(f, iy0 + dy);
          const float* wrow = ws + ((dt * kh + dy) * kw) * p.cc + cl;
          for (int dx = dx0; dx < dx1; ++dx) {
            float xv[VEC], wv[VEC];
            load_vec<T, VEC>(row + dx * pb, xv);
            load_w<VEC>(wrow + dx * p.cc, wv);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = fmaf(xv[j], wv[j], acc[j]);
          }
        }
      }
    }
    const size_t o = ((((size_t)b * p.To + to) * p.Ho + oy) * p.Wo + ox) * p.C + c0 + cl;
    store_vec<T, VEC>(out + o, acc);
  }
}

using KernelFn = void (*)(const Params);

template <typename T, int VEC>
KernelFn pick_ks(const Params& p) {
  if (p.kh == 3 && p.kw == 3) return depthwise_conv3d_kernel<T, VEC, 3>;
  if (p.kh == 1 && p.kw == 1) return depthwise_conv3d_kernel<T, VEC, 1>;
  return depthwise_conv3d_kernel<T, VEC, 0>;
}

KernelFn pick_kernel(int dtype, int vec, const Params& p) {
  if (dtype == 1) {
    switch (vec) {
      case 8: return pick_ks<bf16, 8>(p);
      case 4: return pick_ks<bf16, 4>(p);
      case 2: return pick_ks<bf16, 2>(p);
      case 1: return pick_ks<bf16, 1>(p);
    }
  } else if (dtype == 0) {
    switch (vec) {
      case 4: return pick_ks<float, 4>(p);
      case 2: return pick_ks<float, 2>(p);
      case 1: return pick_ks<float, 1>(p);
    }
  }
  return nullptr;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec, tt, oh, ow, cc and smem come from
// ops/depthwise_conv.py:plan_depthwise; the launch recomputes the shared
// memory from the plan and refuses a plan it does not take. Returns a
// cudaError_t (0 on success).
extern "C" int c3d_depthwise_conv3d(int dtype, const void* x, const void* w, void* out, int B,
                                    int T, int H, int W, int C, int kt, int kh, int kw, int st,
                                    int sh, int sw, int pt, int ph, int pw, int vec, int tt,
                                    int oh, int ow, int cc, int smem, void* stream) {
  Params p{};
  p.x = x; p.w = static_cast<const float*>(w); p.out = out;
  p.B = B; p.T = T; p.H = H; p.W = W; p.C = C;
  p.kt = kt; p.kh = kh; p.kw = kw; p.st = st; p.sh = sh; p.sw = sw; p.pt = pt; p.ph = ph; p.pw = pw;
  p.tt = tt; p.oh = oh; p.ow = ow; p.cc = cc;
  const int es = dtype == 1 ? 2 : 4;
  if (B < 1 || C < 1 || kt < 1 || kh < 1 || kw < 1 || st < 1 || sh < 1 || sw < 1 || pt < 0 ||
      ph < 0 || pw < 0 || tt < 1 || oh < 1 || ow < 1 || vec < 1 || cc < vec || cc > C ||
      cc % vec || C % vec || (cc < C && vec * es < 4) ||
      B > 65535 || (long long)vec * es > 16)
    return (int)cudaErrorInvalidValue;
  p.To = (T + 2 * pt - kt) / st + 1;
  p.Ho = (H + 2 * ph - kh) / sh + 1;
  p.Wo = (W + 2 * pw - kw) / sw + 1;
  if (T + 2 * pt < kt || H + 2 * ph < kh || W + 2 * pw < kw) return (int)cudaErrorInvalidValue;
  p.nf = std::min((tt - 1) * st + kt, T);
  p.ih = (oh - 1) * sh + kh;
  p.iw = (ow - 1) * sw + kw;
  p.row_bytes = row_bytes(p.iw, cc, es);
  const int threads = oh * ow * (cc / vec);
  const long long need = (long long)p.nf * p.ih * p.row_bytes + (long long)kt * kh * kw * cc * 4;
  if (threads > kMaxThreads || need != smem) return (int)cudaErrorInvalidValue;
  KernelFn kernel = pick_kernel(dtype, vec, p);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)ceil_div(p.Wo, ow) * ceil_div(p.Ho, oh) *
                           ceil_div(p.To, tt) * ceil_div(C, cc);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, B);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* c3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
