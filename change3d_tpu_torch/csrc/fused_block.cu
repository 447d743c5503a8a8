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
//                        writes its own row in a fixed order, so reruns are
//                        bit-identical.
//
// Grid: (tile, sample). A block owns tt frames of a tile x tile pixel tile
// plus a 1-pixel H/W halo (the Pallas kernels tile H only, because W fits
// whole in VMEM; 227 KB of shared memory does not hold a row band here).
// Where one T-tile covers the clip (tt = T, every Change3D clip) T pads with
// zero frames; a shorter T-tile (16-frame Kinetics clips at stages 3-4)
// also reads the frame before and after it, zeros outside the clip, and
// recomputes conv_a -> BN -> ReLU there: 2/tt more conv_a work. Blocks are
// numbered T-tile outermost, then row-major. Each output voxel sums its
// taps and channels in the same order whatever tt is. Every kernel is
// instantiated with and without T-tiles, so that a clip in one T-tile pays
// for no frame check. The inner channels
// Ci are walked in chunks of ck. ops/fused_block.py:plan_block picks tt,
// tile and ck from the layouts below and passes the byte count, which the
// launch checks.
//
// Rounding follows the Pallas kernel: xa rounds to the I/O dtype after
// conv_a+BN+ReLU (fused_block.py:45), the swish output rounds before conv_c
// (:69), the output rounds once at the store (:75). Out-of-image halo pixels
// are zeroed in xa-space, after conv_a+BN+ReLU (:112-117): conv_a+BN maps a
// zero pixel to relu(b_a) != 0.
//
// What bounds it on the H100: 2*T*H*W*Ci*(2C+27) flops on 2*|x| bytes. The
// two 1x1 convs are far above the bf16 ridge and the 27 depthwise taps run
// in fp32 on CUDA cores (67 TFLOP/s), so at every X3D-L stage the bound is
// the taps, at a few us per launch.
//
// bf16 (the serving path), one tile code for both kernels, 256 threads a tile:
//   front (shared):
//     x tile + halo  -> shared memory as bf16 by 16-byte cp.async (zeros
//                       outside the image and in the K padding);
//     conv_a         -> mma.sync m16n8k16 bf16 -> fp32 on tensor cores, w_a
//                       chunk staged transposed in shared memory, zero padded
//                       to K = C rounded up to 16 and N = ck rounded to 16; a
//                       warp item is one m16 tile x four n8 tiles (one A
//                       fragment load per k step, four independent mma);
//     BN_a, ReLU, bf16 round, halo zeroing -> xa (bf16);
//     27 taps        -> fp32 on CUDA cores; a thread owns two channels x kXg
//                       (8 where the tile allows, else 4) outputs along W and
//                       slides a (kXg + 2)-pixel window, so each xa value is
//                       loaded once per (dt, dy) row, not per tap; then BN_b.
//   fused_block_fwd: gate, swish, bf16 round -> xs (conv_c's A operand);
//     conv_c on tensor cores with the accumulators in registers across all
//     Ci chunks (each warp owns fixed m16n8 output tiles); epilogue BN_c +
//     residual (from the staged x tile) + ReLU, one rounding, written back
//     into the x tile's core and stored with 16-byte stores.
//   fused_block_se_sums: each thread sums its four outputs, the partial rows
//     go to shared memory, and a fixed-order pass per channel writes the
//     block's row of sums.
//   Shared memory per staged block, or per tile of a resident block, which
//   holds no wa / wc (rows padded by 8 bf16 = 16 bytes, so that the 32-bit
//   fragment loads of a warp hit 32 distinct banks):
//   (F = halo_frames(T, tt): tt + 2, or T when tt = T)
//     xt   bf16 [pad16(F*(tile+2)^2)][pad16(C)+8]   x tile with halo (+ output)
//     wa   bf16 [pad16(ck)][pad16(C)+8]             w_a chunk, [n][k]
//     xa   bf16 [F*(tile+2)^2][pad16(ck)]           conv_a+BN+ReLU chunk
//     fwd:  xs bf16 [pad16(tt*tile^2)][pad16(ck)+8] swish chunk, [m][k]
//           wc bf16 [C][pad16(ck)+8]                w_c chunk, [n][k]
//     sums: part float [tt*tile*tile/4][pad16(ck)]  per-thread partial sums
//   Tiles are 16, 8 or 4 (a multiple of the 4-wide tap window), chosen so that
//   two blocks fit an SM (112 KB each, with the L1 carveout set to the most
//   shared memory) and a warp owns at most 16 conv_c tiles (64 fp32
//   accumulators in registers, __launch_bounds__(256, 2) caps a thread at 128
//   registers). Needs C % 8 == 0 and Ci % 2 == 0.
//
// Two designs run those tiles, the same code per tile (bf16_tile):
//   staged (fused_block_bf16_kernel): a block per (tile, sample), two blocks
//     an SM; every chunk stages its slice of w_a and w_c transposed into the
//     block's shared memory, so a 4 x 4 tile of 48-80 outputs re-stages up to
//     ~90 KB of weights. The x tile's cp.async overlaps the first chunk's
//     weight loads only.
//   weight-resident (fused_block_resident_kernel; X3D-L's stage 3, where
//     ops/fused_block.py:plan_block finds that the weights fit): persistent
//     blocks, one an SM, of two 8-warp groups. A block copies all of w_a and
//     w_c into shared memory once, by 16-byte cp.async, in their [k][n]
//     global layout with rows padded to an odd number of 16-byte units; the
//     mma's b fragments come from them by ldmatrix .trans, so a chunk costs
//     barriers only. Each group works through its own tiles with its own
//     named barrier, so one group's loads and barriers overlap the other's
//     products, as two staged blocks on an SM do. Besides: the BN vectors
//     also sit in shared memory (so L1 keeps the taps' w_dw), a tap thread
//     owns two rows (their weight loads and two of three xa rows shared),
//     and conv_c steps two accumulator tiles at a time. The same chunks
//     give the same K order and every sum its order: the designs agree bit
//     for bit at the same ck.
//   split (T-tiled plans, tt < T: 16-frame Kinetics clips at stages 3-4):
//     a staged T-tile recomputes conv_a on its tile's whole halo for every
//     chunk (stage 4's 3 x 4 x 4 outputs read 5 x 6 x 6 halo pixels: 6.5x
//     the conv_a work of the clip). Here fused_block_xa_kernel computes xa
//     once per position into a bf16 [B,T,H,W,Ci] buffer (the same mma K
//     order from zero, the same BN_a, ReLU and rounding: the same values),
//     and fused_block_xa_tail_kernel runs the tile code without conv_a: each
//     chunk's xa halo and w_c rows ([k][n], read by ldmatrix .trans) arrive
//     by 16-byte cp.async, double-buffered so that the next chunk's copy
//     overlaps this chunk's taps and conv_c; x is read only at the tile's
//     core, for the residual. The staged plan's tt and tile, so the se-sums
//     rows are the same; chunks of a multiple of 16 channels, so conv_c's
//     16-deep K steps group the same channels as at ck = 16: bit-equal to
//     the staged kernel.
//
// fp32 (the correctness path) keeps the first, scalar design: both products
// as fp32 FMAs on CUDA cores, conv_c accumulated in fp32 shared memory. It
// stays exact fp32 (no TF32). Shared memory per block:
//   acc  float [tt*tile*tile][C], xa float [F*(tile+2)^2][ck],
//   xs   float [tt*tile*tile][ck], xt float [F*(tile+2)^2][C].

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
using c3d::from_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
  int tt;  // frames per T-tile; after the others, since only the T-tiled kernels read it
  int B;   // samples; read by the persistent (resident) kernels and the xa pass only
  const void* xa;  // [B,T,H,W,round_up(Ci, 8)] bf16: the xa pass output, split tail input
};

// Frames a T-tile of tt frames reads (ops/fused_block.py:halo_frames).
__host__ __device__ __forceinline__ int halo_frames(int T, int tt) {
  return tt < T ? tt + 2 : T;
}

// Where tile `id` of a sample lies: its first output frame t0, the clip
// frame of its halo frame 0 (f0), and its first output row and column. A kernel
// instantiated without T-tiles (kTTiled false: one T-tile holds the clip)
// has t0 = f0 = 0 and every frame check folded away at compile time, so it
// runs the code of an untiled clip.
template <bool kTTiled>
struct TilePos {
  int t0 = 0, f0 = 0, y0, x0;
  __device__ __forceinline__ TilePos(const Params& p, int id, int tile) {
    const int tiles_w = (p.W + tile - 1) / tile;
    if (kTTiled) {
      const int tiles_hw = ((p.H + tile - 1) / tile) * tiles_w;
      t0 = (id / tiles_hw) * p.tt;
      f0 = t0 - 1;
      id %= tiles_hw;
    }
    y0 = (id / tiles_w) * tile;
    x0 = (id % tiles_w) * tile;
  }
  // Whether clip frame gt exists (always, for a frame of an untiled clip).
  __device__ __forceinline__ bool has_frame(int gt, int T) const {
    return !kTTiled || (gt >= 0 && gt < T);
  }
};

// ---------------------------------------------------------------------------
// fp32: scalar CUDA-core products
// ---------------------------------------------------------------------------

template <bool kSums, bool kTTiled>
__global__ void __launch_bounds__(kThreads) fused_block_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, H = p.H, W = p.W, C = p.C, Ci = p.Ci;
  const int tile = p.tile, ck = p.ck, tt = kTTiled ? p.tt : T;  // tt = T untiled
  const int hw = tile + 2;                             // halo tile side
  const int n_halo = halo_frames(T, tt) * hw * hw;     // halo pixels
  const int n_core = tt * tile * tile;                 // output pixels
  const int tile_id = blockIdx.x;
  const int b = blockIdx.y;
  const TilePos<kTTiled> P(p, tile_id, p.tile);
  const int t0 = P.t0, f0 = P.f0, y0 = P.y0, x0 = P.x0;

  float* acc = reinterpret_cast<float*>(smem);
  float* xa = acc + (kSums ? 0 : n_core * C);
  float* xs = xa + n_halo * ck;
  float* xt = xs + n_core * ck;

  const size_t sample = (size_t)T * H * W * C;
  const float* xg = static_cast<const float*>(p.x) + (size_t)b * sample;
  const float* wa = static_cast<const float*>(p.w_a);
  const float* wc = static_cast<const float*>(p.w_c);

  // Input tile with halo; pixels outside the clip hold 0 (never used:
  // their xa is forced to 0 below, and they have no output).
  for (int e = threadIdx.x; e < n_halo * C; e += blockDim.x) {
    const int c = e % C, pos = e / C;
    const int xx = pos % hw, yy = (pos / hw) % hw, gt = f0 + pos / (hw * hw);
    const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
    float v = 0.f;
    if (P.has_frame(gt, T) && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xg[(((size_t)gt * H + gy) * W + gx) * C + c];
    xt[e] = v;
  }
  if (!kSums)
    for (int e = threadIdx.x; e < n_core * C; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();

  for (int ci0 = 0; ci0 < Ci; ci0 += ck) {
    const int kc = min(ck, Ci - ci0);

    // conv_a (fp32 accumulate) -> BN_a -> ReLU; 0 outside the clip.
    for (int e = threadIdx.x; e < n_halo * kc; e += blockDim.x) {
      const int k = e % kc, pos = e / kc;
      const int xx = pos % hw, yy = (pos / hw) % hw, gt = f0 + pos / (hw * hw);
      const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
      float v = 0.f;
      if (P.has_frame(gt, T) && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int ci = ci0 + k;
        const float* xr = xt + (size_t)pos * C;
        float s = 0.f;
        for (int c = 0; c < C; ++c) s = fmaf(xr[c], wa[(size_t)c * Ci + ci], s);
        v = fmaxf(s * p.a_a[ci] + p.b_a[ci], 0.f);
      }
      xa[pos * ck + k] = v;
    }
    __syncthreads();

    // 27 depthwise taps in fp32 (T zero-padded) -> BN_b, then either the
    // squeeze input (se_sums) or gate -> swish (fwd).
    for (int e = threadIdx.x; e < n_core * kc; e += blockDim.x) {
      const int k = e % kc, q = e / kc;
      const int tx = q % tile, ty = (q / tile) % tile, t = q / (tile * tile);
      const int ci = ci0 + k;
      float s = 0.f;
      for (int dt = 0; dt < 3; ++dt) {
        const int gt = t0 + t + dt - 1;  // clip frame of the tap
        if (gt < 0 || gt >= T) continue;
        const int f = gt - f0;           // its halo frame
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx)
            s = fmaf(xa[((f * hw + ty + dy) * hw + tx + dx) * ck + k],
                     p.w_dw[((dt * 3 + dy) * 3 + dx) * Ci + ci], s);
      }
      float xb = s * p.a_b[ci] + p.b_b[ci];
      if (kSums) {
        const bool inside = P.has_frame(t0 + t, T) && (y0 + ty) < H && (x0 + tx) < W;
        xs[q * ck + k] = inside ? xb : 0.f;
      } else {
        if (p.gate != nullptr) xb *= p.gate[(size_t)b * Ci + ci];
        xs[q * ck + k] = xb / (1.f + expf(-xb));
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
        for (int k = 0; k < kc; ++k) s = fmaf(xr[k], wc[(size_t)(ci0 + k) * C + c], s);
        acc[e] = s;
      }
    }
    __syncthreads();
  }

  if (!kSums) {
    // BN_c + residual -> ReLU.
    float* og = static_cast<float*>(p.out) + (size_t)b * sample;
    for (int e = threadIdx.x; e < n_core * C; e += blockDim.x) {
      const int c = e % C, q = e / C;
      const int tx = q % tile, ty = (q / tile) % tile, t = q / (tile * tile);
      const int gt = t0 + t, gy = y0 + ty, gx = x0 + tx;
      if (!P.has_frame(gt, T) || gy >= H || gx >= W) continue;
      const float r = xt[(((gt - f0) * hw + ty + 1) * hw + tx + 1) * C + c];
      og[(((size_t)gt * H + gy) * W + gx) * C + c] = fmaxf(acc[e] * p.a_c[c] + p.b_c[c] + r, 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products, bf16 staging
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// A row stride (elements) for rows of n bf16 that is an odd number of 16-byte
// units, so that the eight rows an ldmatrix reads hit eight distinct groups
// of four banks.
__host__ __device__ constexpr int odd16_stride(int n) {
  return round_up(n, 8) / 8 % 2 ? round_up(n, 8) : round_up(n, 8) + 8;
}

// The bf16 shared-memory layout of one tile (byte offsets); ops/fused_block.py
// mirrors it in _bf16_smem. A weight-resident block's tiles hold no weights
// (staged = false): its weights lie once in front of them (ResidentLayout).
struct Bf16Layout {
  int hw, nh, nhp, nc, ncp, kp, sx, ckp, ss;
  int off_wa, off_xa, off_xs, off_wc, off_part, bytes_fwd, bytes_sums;
  __host__ __device__ Bf16Layout(int T, int tt, int tile, int C, int ck, bool staged = true) {
    hw = tile + 2;
    nh = halo_frames(T, tt) * hw * hw;  // halo pixels
    nhp = round_up(nh, 16);             // ... padded to the mma's 16 rows
    nc = tt * tile * tile;              // output pixels
    ncp = round_up(nc, 16);
    kp = round_up(C, 16);        // conv_a depth
    sx = kp + 8;                 // xt / wa row stride (elements)
    ckp = round_up(ck, 16);      // conv_a width, conv_c depth
    ss = ckp + 8;                // xs / wc row stride
    off_wa = nhp * sx * 2;
    off_xa = off_wa + (staged ? ckp * sx * 2 : 0);
    off_xs = off_xa + nh * ckp * 2;
    off_wc = off_xs + ncp * ss * 2;
    bytes_fwd = off_wc + (staged ? C * ss * 2 : 0);
    off_part = off_xs;
    bytes_sums = off_part + tt * tile * (tile / 4) * ckp * 4;
  }
};

// The weight-resident block: w_a as [pad16(C)][sa] and (fwd) w_c as
// [rows_c][sc], both [k][n] as they lie in global memory, rows padded to an
// odd number of 16-byte units; the fp32 BN vectors a_a, b_a, a_b, b_b [Ci]
// and (fwd) a_c, b_c [C]; then kGroups tiles (Bf16Layout, no weights).
// w_c's rows reach the last chunk's start plus pad16(ck) (rows from Ci on
// are zero); ops/fused_block.py mirrors it in _resident_smem. With the
// vectors in shared memory, L1 (what the carveout leaves: 28 KB) keeps the
// taps' fp32 w_dw.
constexpr int kGroups = 2;
constexpr int kResidentTile = 4;  // its tile side, and its tap threads' outputs along W
struct ResidentLayout {
  Bf16Layout tile;
  int sa, sc, rows_c, off_wc, off_vec[2], off_tiles[2], bytes_fwd, bytes_sums;
  __host__ __device__ ResidentLayout(int T, int tile_side, int C, int Ci, int ck)
      : tile(T, T, tile_side, C, ck, false) {
    sa = odd16_stride(Ci);
    sc = odd16_stride(C);
    rows_c = (Ci + ck - 1) / ck * ck - ck + round_up(ck, 16);
    off_wc = round_up(C, 16) * sa * 2;
    off_vec[0] = off_wc + rows_c * sc * 2;  // [0]: fwd, [1]: sums (no w_c, a_c, b_c)
    off_vec[1] = off_wc;
    off_tiles[0] = off_vec[0] + (4 * Ci + 2 * C) * 4;
    off_tiles[1] = off_vec[1] + 4 * Ci * 4;
    bytes_fwd = off_tiles[0] + kGroups * tile.bytes_fwd;
    bytes_sums = off_tiles[1] + kGroups * tile.bytes_sums;
  }
};

// A split tail's tile (Bf16Layout's sizes, other regions): two buffers of
// the xa halo chunk, [nh][pad16(ck)]; for fwd two of w_c's chunk rows,
// [pad16(ck)][sc] ([k][n], rows an odd number of 16-byte units), xs as in
// Bf16Layout and the x tile's core, [nc][sx] (the residual, then the
// output); for se_sums the partial sums after the xa buffers.
// ops/fused_block.py mirrors it in _split_smem.
struct SplitLayout {
  Bf16Layout g;
  int sc, xa_bytes, wc_bytes, off_xs, off_xt, off_part, bytes_fwd, bytes_sums;
  __host__ __device__ SplitLayout(int T, int tt, int tile, int C, int ck)
      : g(T, tt, tile, C, ck) {
    sc = odd16_stride(C);
    xa_bytes = g.nh * g.ckp * 2;
    wc_bytes = g.ckp * sc * 2;
    off_xs = 2 * xa_bytes + 2 * wc_bytes;
    off_xt = off_xs + g.ncp * g.ss * 2;
    bytes_fwd = off_xt + g.nc * g.sx * 2;
    off_part = 2 * xa_bytes;
    bytes_sums = off_part + tt * tile * (tile / 4) * g.ckp * 4;
  }
  // Buffer i (0 or 1) of the xa halo chunk, and of w_c's chunk rows.
  __device__ int off_xa(int i) const { return i * xa_bytes; }
  __device__ int off_wc(int i) const { return 2 * xa_bytes + i * wc_bytes; }
};

// The xa pass: blocks of kXaRows positions, Ci in slabs of kXaCols
// channels. Its shared memory: the x rows [kXaRows][pad16(C)+8], a slab of
// w_a's columns [pad16(C)][sb] ([k][n], rows an odd number of 16-byte
// units) and the slab's output [kXaRows][kXaCols+8]; ops/fused_block.py
// mirrors it in _xa_smem.
constexpr int kXaRows = 16 * kWarps, kXaCols = 64;
struct XaLayout {
  int kp, sx, sb, so, off_w, off_o, bytes;
  __host__ __device__ explicit XaLayout(int C) {
    kp = round_up(C, 16);
    sx = kp + 8;
    sb = odd16_stride(kXaCols);
    so = kXaCols + 8;
    off_w = kXaRows * sx * 2;
    off_o = off_w + kp * sb * 2;
    bytes = off_o + kXaRows * so * 2;
  }
};

// A resident block's weights and BN vectors as a tile reads them (unused by
// a staged block, which reads the vectors from global memory).
struct Resident {
  const bf16* wa;
  const bf16* wc;
  int sa, sc;
  const float *a_a, *b_a, *a_b, *b_b, *a_c, *b_c;
};

// Two fp32 values of a BN vector: by a read-only global load, or from a
// resident block's shared memory.
template <bool kShared>
__device__ __forceinline__ float2 ld_f2(const float* p) {
  if constexpr (kShared)
    return *reinterpret_cast<const float2*>(p);
  else
    return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies n_row x n_col elements of a row-major global matrix (row stride ld)
// into shared memory transposed, dst[col * dst_ld + row], with zeros where
// row >= rows or col >= cols. Each thread keeps 8 loads in flight.
__device__ __forceinline__ void stage_transposed(bf16* dst, int dst_ld, const bf16* src,
                                                 size_t ld, int n_row, int n_col, int rows,
                                                 int cols, int tid) {
  const int total = n_row * n_col;
  const bf16 zero = from_f<bf16>(0.f);
  for (int e0 = tid; e0 < total; e0 += 8 * kThreads) {
    bf16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * kThreads, col = e % n_col, row = e / n_col;
      v[i] = (e < total && row < rows && col < cols) ? src[row * ld + col] : zero;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * kThreads;
      if (e < total) dst[(e % n_col) * dst_ld + e / n_col] = v[i];
    }
  }
}

// A split tail's chunk ci0 (kc channels) into one of its buffers: the tile's
// xa halo rows by 16-byte cp.async per 8 channels of an in-clip pixel
// (zeros outside the clip; xa's rows hold Ci rounded up to 8, the last
// channels zero) and, for fwd, w_c's rows ci0.. as [k][n] (zeros in the
// rows past kc, which the last chunk's K padding reads).
// Each thread walks its (row, 8-channel group) elements e = tid, tid +
// kThreads, ... by stepping the row and the group, without a division per
// element. kTile: the tile side where it is fixed at compile time, else 0.
template <bool kSums, int kTile, bool kTTiled>
__device__ __forceinline__ void split_chunk(const Params& p, const TilePos<kTTiled>& P,
                                            const SplitLayout& S, int b, int ci0, int kc,
                                            bf16* xa_s, bf16* wc_s, int tid) {
  const int hw = kTile ? kTile + 2 : S.g.hw, k8 = (kc + 7) / 8, cis = round_up(p.Ci, 8);
  const bf16* xag = static_cast<const bf16*>(p.xa) + (size_t)b * p.T * p.H * p.W * cis + ci0;
  const int dq = kThreads / k8, dr = kThreads % k8;
  for (int pos = tid / k8, j = tid % k8; pos < S.g.nh;) {
    const int xx = pos % hw, yy = (pos / hw) % hw, gt = P.f0 + pos / (hw * hw);
    const int gy = P.y0 - 1 + yy, gx = P.x0 - 1 + xx;
    uint4* dst = reinterpret_cast<uint4*>(xa_s + pos * S.g.ckp + j * 8);
    if (P.has_frame(gt, p.T) && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
      c3d::cp_async16(dst, xag + (((size_t)gt * p.H + gy) * p.W + gx) * cis + j * 8);
    else
      *dst = make_uint4(0, 0, 0, 0);
    pos += dq;
    j += dr;
    if (j >= k8) {
      j -= k8;
      ++pos;
    }
  }
  if (!kSums) {
    const int c8 = p.C / 8, cq = kThreads / c8, cr = kThreads % c8;
    const bf16* wc = static_cast<const bf16*>(p.w_c) + (size_t)ci0 * p.C;
    for (int k = tid / c8, j = tid % c8; k < S.g.ckp;) {
      uint4* dst = reinterpret_cast<uint4*>(wc_s + k * S.sc + j * 8);
      if (k < kc)
        c3d::cp_async16(dst, wc + (size_t)k * p.C + j * 8);
      else
        *dst = make_uint4(0, 0, 0, 0);
      k += cq;
      j += cr;
      if (j >= c8) {
        j -= c8;
        ++k;
      }
    }
  }
}

// The barrier of the threads that work on one tile: the whole block, or in
// a resident block its group's named barrier (barrier 0 is __syncthreads').
template <bool kResident>
__device__ __forceinline__ void tile_sync(int group) {
  if constexpr (kResident)
    asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kThreads) : "memory");
  else
    __syncthreads();
}

// One tile (sample b, tile tile_id of the sample's n_tiles) by kThreads
// threads (tid), in the tile's shared memory `smem`. A staged block stages
// each chunk's weights transposed ([n][k]) and reads them by 32-bit loads; a
// resident block reads its resident [k][n] weights by ldmatrix .trans, a
// split tail its chunk's [k][n] w_c rows likewise. All feed the mma the same
// fragments, in the same K order. A split tail (kSplit) reads xa from the
// xa pass's output instead of computing conv_a, and holds x's core only.
// kXg: outputs along W per tap thread (4 or 8; the tile is a multiple).
// kTile: the tile side where it is fixed at compile time (the resident
// design's, so that the index arithmetic divides by constants), else 0.
template <bool kSums, int kAcc, int kXg, bool kTTiled, bool kResident, int kTile = 0,
          bool kSplit = false>
__device__ __forceinline__ void bf16_tile(const Params& p, unsigned char* smem, const Resident& R,
                                          int b, int tile_id, int n_tiles, int tid, int group) {
  const int T = p.T, H = p.H, W = p.W, C = p.C, Ci = p.Ci;
  const int tile = kTile ? kTile : p.tile, ck = p.ck, tt = kTTiled ? p.tt : T;  // tt = T untiled
  const Bf16Layout L(T, tt, tile, C, ck, !kResident);
  const SplitLayout S(T, tt, tile, C, ck);  // read by a split tail only
  const int hw = L.hw, sx = L.sx, ss = L.ss, ckp = L.ckp;
  const TilePos<kTTiled> P(p, tile_id, tile);
  const int t0 = P.t0, f0 = P.f0, y0 = P.y0, x0 = P.x0;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
  C3D_PHASE(0);

  // A split tail's x tile is its core: row q for output pixel q.
  bf16* xt = reinterpret_cast<bf16*>(smem + (kSplit ? S.off_xt : 0));
  bf16* wa_s = reinterpret_cast<bf16*>(smem + L.off_wa);
  bf16* xa = reinterpret_cast<bf16*>(smem + L.off_xa);
  bf16* xs = reinterpret_cast<bf16*>(smem + (kSplit ? S.off_xs : L.off_xs));
  bf16* wc_s = reinterpret_cast<bf16*>(smem + L.off_wc);
  float* part = reinterpret_cast<float*>(smem + (kSplit ? S.off_part : L.off_part));

  const size_t sample = (size_t)T * H * W * C;
  const bf16* xg = static_cast<const bf16*>(p.x) + (size_t)b * sample;
  const bf16* wa = static_cast<const bf16*>(p.w_a);
  const bf16* wc = static_cast<const bf16*>(p.w_c);
  const float* a_a = kResident ? R.a_a : p.a_a;
  const float* b_a = kResident ? R.b_a : p.b_a;
  const float* a_b = kResident ? R.a_b : p.a_b;
  const float* b_b = kResident ? R.b_b : p.b_b;

  if constexpr (kSplit) {
    // x's core (fwd: the residual) and the first chunk, by 16-byte cp.async.
    if (!kSums) {
      const int c8 = C / 8;
      for (int e = tid; e < L.nc * c8; e += kThreads) {
        const int j = e % c8, q = e / c8;
        const int gt = t0 + q / (tile * tile), gy = y0 + (q / tile) % tile, gx = x0 + q % tile;
        uint4* dst = reinterpret_cast<uint4*>(xt + q * sx + j * 8);
        if (P.has_frame(gt, T) && gy < H && gx < W)
          c3d::cp_async16(dst, xg + (((size_t)gt * H + gy) * W + gx) * C + j * 8);
        else
          *dst = make_uint4(0, 0, 0, 0);
      }
    }
    split_chunk<kSums, kTile>(p, P, S, b, 0, min(ck, Ci),
                              reinterpret_cast<bf16*>(smem + S.off_xa(0)),
                              reinterpret_cast<bf16*>(smem + S.off_wc(0)), tid);
  } else {
    // x tile with halo: 16-byte cp.async per 8 channels of an in-clip pixel;
    // zeros outside the clip, in the K padding and in the padding rows.
    const int c8 = C / 8, s8 = sx / 8;
    for (int e = tid; e < L.nhp * s8; e += kThreads) {
      const int j = e % s8, pos = e / s8;
      uint4* dst = reinterpret_cast<uint4*>(xt + pos * sx + j * 8);
      const bf16* src = nullptr;
      if (pos < L.nh && j < c8) {
        const int xx = pos % hw, yy = (pos / hw) % hw, gt = f0 + pos / (hw * hw);
        const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
        if (P.has_frame(gt, T) && gy >= 0 && gy < H && gx >= 0 && gx < W)
          src = xg + (((size_t)gt * H + gy) * W + gx) * C + j * 8;
      }
      if (src != nullptr)
        c3d::cp_async16(dst, src);
      else
        *dst = make_uint4(0, 0, 0, 0);
    }
  }
  if (!kSums)  // xs starts at zero: its padding rows and columns stay finite
    for (int e = tid; e < L.ncp * ss / 8; e += kThreads)
      reinterpret_cast<uint4*>(xs)[e] = make_uint4(0, 0, 0, 0);
  C3D_PHASE(1);

  const int n_nt = C / 8;                  // conv_c n8 tiles
  const int n_tc = (L.ncp / 16) * n_nt;    // conv_c m16n8 tiles
  float acc[kAcc][4];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += ck) {
    const int kc = min(ck, Ci - ci0);
    if (ci0 + ck >= Ci) C3D_PHASE(14);

    // A staged block's chunk of weights, transposed to [n][k] and zero
    // padded (the first chunk's loads overlap the x tile's cp.async).
    if (!kResident && !kSplit) {
      stage_transposed(wa_s, sx, wa + ci0, Ci, L.kp, ckp, C, kc, tid);
      if (!kSums) stage_transposed(wc_s, ss, wc + (size_t)ci0 * C, C, ckp, C, kc, C, tid);
    }
    c3d::cp_async_wait_all();
    tile_sync<kResident>(group);
    C3D_PHASE(ci0 == 0 ? 2 : 10);

    // A split tail's buffers of this chunk (its xa, its [k][n] w_c rows),
    // and the next chunk's copy into the others: all threads are past the
    // barrier above, so done with the chunk that used them.
    const bf16* xa_c = xa;
    const bf16* wc_k = nullptr;
    if constexpr (kSplit) {
      const int buf = (ci0 / ck) & 1;
      xa_c = reinterpret_cast<const bf16*>(smem + S.off_xa(buf));
      wc_k = reinterpret_cast<const bf16*>(smem + S.off_wc(buf));
      if (ci0 + ck < Ci)
        split_chunk<kSums, kTile>(p, P, S, b, ci0 + ck, min(ck, Ci - ci0 - ck),
                                  reinterpret_cast<bf16*>(smem + S.off_xa(buf ^ 1)),
                                  reinterpret_cast<bf16*>(smem + S.off_wc(buf ^ 1)), tid);
    } else {
    // conv_a on tensor cores -> BN_a -> ReLU -> bf16; 0 outside the clip.
    // A warp item is one m16 row tile x four n8 tiles: the A fragment is
    // loaded once per k step for four independent mma.
      const int n_at = (kc + 7) / 8, n_grp = (n_at + 3) / 4;
      const int items = (L.nhp / 16) * n_grp;
      for (int it = warp; it < items; it += kWarps) {
        const int mt = it / n_grp, n0 = (it % n_grp) * 4;
        float2 aa[4], ba[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = (n0 + j) * 8 + 2 * tq;
          aa[j] = ba[j] = make_float2(0.f, 0.f);
          if (k < kc) {
            aa[j] = ld_f2<kResident>(a_a + ci0 + k);
            ba[j] = ld_f2<kResident>(b_a + ci0 + k);
          }
        }
        float d[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
        const bf16* a0 = xt + (mt * 16 + g) * sx + 2 * tq;
        const bf16* a1 = a0 + 8 * sx;
        const bf16* bw = wa_s + (n0 * 8 + g) * sx + 2 * tq;
        // Resident: lane l addresses row k0 + l % 16 of n8 tile n0 + l / 16
        // (+ j): two n8 tiles' b fragments per ldmatrix.x4.
        const bf16* br = R.wa + (lane & 15) * R.sa + ci0 + (n0 + (lane >> 4)) * 8;
        for (int k0 = 0; k0 < L.kp; k0 += 16) {
          const uint32_t a[4] = {ld32(a0 + k0), ld32(a1 + k0), ld32(a0 + k0 + 8),
                                 ld32(a1 + k0 + 8)};
          if constexpr (kResident) {
#pragma unroll
            for (int j = 0; j < 4; j += 2)
              if (n0 + j < n_at) {
                uint32_t bq[4];
                c3d::ldmatrix_x4_trans(bq, br + k0 * R.sa + j * 8);
                c3d::mma_bf16_16816(d[j], a, bq[0], bq[1]);
                if (n0 + j + 1 < n_at) c3d::mma_bf16_16816(d[j + 1], a, bq[2], bq[3]);
              }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n0 + j < n_at)
                c3d::mma_bf16_16816(d[j], a, ld32(bw + j * 8 * sx + k0),
                                    ld32(bw + j * 8 * sx + k0 + 8));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = mt * 16 + g + 8 * h;
          if (pos >= L.nh) continue;
          const int xx = pos % hw, yy = (pos / hw) % hw;
          const int gy = y0 - 1 + yy, gx = x0 - 1 + xx;
          const bool in = P.has_frame(f0 + pos / (hw * hw), T) && gy >= 0 && gy < H &&
                          gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = (n0 + j) * 8 + 2 * tq;  // channels of d[j][2h], d[j][2h+1]
            if (k >= kc) continue;
            const uint32_t v =
                in ? c3d::pack_bf16x2(fmaxf(d[j][2 * h] * aa[j].x + ba[j].x, 0.f),
                                      fmaxf(d[j][2 * h + 1] * aa[j].y + ba[j].y, 0.f))
                   : 0u;
            *reinterpret_cast<uint32_t*>(xa + pos * ckp + k) = v;
          }
        }
      }
      tile_sync<kResident>(group);
    }
    C3D_PHASE(ci0 == 0 ? 3 : 11);

    // 27 depthwise taps in fp32 (T zero-padded) -> BN_b. A thread owns
    // channels (k, k+1) of kXg outputs along W in kRows neighbouring rows of
    // one frame: one row in a staged block, two in a resident one or a
    // split tail of 4-wide groups, whose rows share their weight loads and
    // two of their three xa rows. Each output sums its taps in (dt, dy, dx)
    // order either way.
    {
      constexpr int kRows = kResident || (kSplit && kXg == 4) ? 2 : 1;
      const int pairs = kc / 2, xq_n = tile / kXg, rows = tt * tile / kRows;
      const int wstride = ckp / 2;  // 32-bit words between neighbouring pixels of xa
      for (int e = tid; e < pairs * rows * xq_n; e += kThreads) {
        const int pp = e % pairs, rest = e / pairs;
        const int xq = rest % xq_n, r0 = rest / xq_n * kRows;
        const int y = r0 % tile, t = r0 / tile;
        const int k = 2 * pp, ci = ci0 + k, xb0 = kXg * xq;
        float2 s[kRows][kXg];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
          for (int i = 0; i < kXg; ++i) s[rr][i] = make_float2(0.f, 0.f);
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const int gt = t0 + t + dt - 1;  // clip frame of the tap
          if (gt < 0 || gt >= T) continue;
#pragma unroll
          for (int iy = 0; iy < kRows + 2; ++iy) {  // xa row y + iy
            const uint32_t* row = reinterpret_cast<const uint32_t*>(
                xa_c + (((gt - f0) * hw + y + iy) * hw + xb0) * ckp + k);
            float2 v[kXg + 2];
#pragma unroll
            for (int i = 0; i < kXg + 2; ++i) v[i] = c3d::unpack_bf16x2(row[i * wstride]);
#pragma unroll
            for (int rr = 0; rr < kRows; ++rr) {
              const int dy = iy - rr;  // the tap of output row y + rr
              if (dy < 0 || dy > 2) continue;
              const float* wt = p.w_dw + (size_t)((dt * 3 + dy) * 3) * Ci + ci;
              const float2 w0 = __ldg(reinterpret_cast<const float2*>(wt));
              const float2 w1 = __ldg(reinterpret_cast<const float2*>(wt + Ci));
              const float2 w2 = __ldg(reinterpret_cast<const float2*>(wt + 2 * Ci));
#pragma unroll
              for (int i = 0; i < kXg; ++i) {
                float2& o = s[rr][i];
                o.x = fmaf(v[i].x, w0.x, o.x);
                o.y = fmaf(v[i].y, w0.y, o.y);
                o.x = fmaf(v[i + 1].x, w1.x, o.x);
                o.y = fmaf(v[i + 1].y, w1.y, o.y);
                o.x = fmaf(v[i + 2].x, w2.x, o.x);
                o.y = fmaf(v[i + 2].y, w2.y, o.y);
              }
            }
          }
        }
        const float2 ab = ld_f2<kResident>(a_b + ci);
        const float2 bb = ld_f2<kResident>(b_b + ci);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int r = r0 + rr;
          if (kSums) {
            float2 tot = make_float2(0.f, 0.f);
            const bool row_in = P.has_frame(t0 + t, T) && y0 + y + rr < H;
#pragma unroll
            for (int i = 0; i < kXg; ++i)
              if (row_in && x0 + xb0 + i < W) {
                tot.x += s[rr][i].x * ab.x + bb.x;
                tot.y += s[rr][i].y * ab.y + bb.y;
              }
            *reinterpret_cast<float2*>(part + (r * xq_n + xq) * ckp + k) = tot;
          } else {
            float2 gt = make_float2(1.f, 1.f);
            if (p.gate != nullptr)
              gt = __ldg(reinterpret_cast<const float2*>(p.gate + (size_t)b * Ci + ci));
#pragma unroll
            for (int i = 0; i < kXg; ++i) {
              float u = s[rr][i].x * ab.x + bb.x, w = s[rr][i].y * ab.y + bb.y;
              if (p.gate != nullptr) {
                u *= gt.x;
                w *= gt.y;
              }
              *reinterpret_cast<uint32_t*>(xs + (r * tile + xb0 + i) * ss + k) =
                  c3d::pack_bf16x2(u / (1.f + expf(-u)), w / (1.f + expf(-w)));
            }
          }
        }
      }
    }
    tile_sync<kResident>(group);
    C3D_PHASE(ci0 == 0 ? 4 : 12);

    if constexpr (kSums) {
      // Fixed-order per-channel sums of the partial rows: four neighbouring
      // lanes split a channel's rows (i = j mod 4), then a fixed shuffle tree.
      const int n_part = tt * tile * (tile / kXg);
      for (int e0 = 0; e0 < 4 * kc; e0 += kThreads) {
        const int e = e0 + tid, k = e >> 2, j = e & 3;
        float s = 0.f;
        if (e < 4 * kc)
          for (int i = j; i < n_part; i += 4) s += part[i * ckp + k];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (e < 4 * kc && j == 0) p.sums[((size_t)b * n_tiles + tile_id) * Ci + ci0 + k] = s;
      }
    } else if constexpr (kResident || kSplit) {
      // conv_c over this chunk, into the warp's register accumulators, two
      // tiles at a time (two independent mma chains). Lanes 0-15 address
      // rows ci0 + k0 + lane of the tile's n8 columns of the resident w_c,
      // or rows k0 + lane of a split tail's chunk of w_c.
      const int sc = kResident ? R.sc : S.sc;
#pragma unroll
      for (int j = 0; j < kAcc; j += 2) {
        const int it0 = warp + j * kWarps, it1 = it0 + kWarps;
        if (it0 < n_tc) {
          const bool two = it1 < n_tc;
          const bf16* a0 = xs + ((it0 / n_nt) * 16 + g) * ss + 2 * tq;
          const bf16* a1 = xs + ((it1 / n_nt) * 16 + g) * ss + 2 * tq;
          const bf16* b0 = kResident ? R.wc + (ci0 + (lane & 15)) * R.sc + (it0 % n_nt) * 8
                                     : wc_k + (lane & 15) * sc + (it0 % n_nt) * 8;
          const bf16* b1 = kResident ? R.wc + (ci0 + (lane & 15)) * R.sc + (it1 % n_nt) * 8
                                     : wc_k + (lane & 15) * sc + (it1 % n_nt) * 8;
          for (int k0 = 0; k0 < ckp; k0 += 16) {
            uint32_t bq[2];
            const uint32_t a[4] = {ld32(a0 + k0), ld32(a0 + 8 * ss + k0), ld32(a0 + k0 + 8),
                                   ld32(a0 + 8 * ss + k0 + 8)};
            c3d::ldmatrix_x2_trans(bq, b0 + k0 * sc);
            c3d::mma_bf16_16816(acc[j], a, bq[0], bq[1]);
            if (two) {
              const uint32_t a_[4] = {ld32(a1 + k0), ld32(a1 + 8 * ss + k0), ld32(a1 + k0 + 8),
                                      ld32(a1 + 8 * ss + k0 + 8)};
              c3d::ldmatrix_x2_trans(bq, b1 + k0 * sc);
              c3d::mma_bf16_16816(acc[j + 1], a_, bq[0], bq[1]);
            }
          }
        }
      }
    } else {
      // conv_c over this chunk, into the warp's register accumulators.
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int it = warp + j * kWarps;
        if (it < n_tc) {
          const int mt = it / n_nt, nt = it % n_nt;
          const bf16* a0 = xs + (mt * 16 + g) * ss + 2 * tq;
          const bf16* a1 = a0 + 8 * ss;
          const bf16* bw = wc_s + (nt * 8 + g) * ss + 2 * tq;
          for (int k0 = 0; k0 < ckp; k0 += 16) {
            const uint32_t a[4] = {ld32(a0 + k0), ld32(a1 + k0), ld32(a0 + k0 + 8),
                                   ld32(a1 + k0 + 8)};
            c3d::mma_bf16_16816(acc[j], a, ld32(bw + k0), ld32(bw + k0 + 8));
          }
        }
      }
    }
    // (A split tail's next chunk starts with a barrier before its writes.)
    if constexpr (!kSplit) tile_sync<kResident>(group);
    C3D_PHASE(ci0 == 0 ? 5 : 13);
  }

  if (!kSums) {
    // BN_c + residual -> ReLU -> one rounding, written over the x tile's core.
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int it = warp + j * kWarps;
      if (it < n_tc) {
        const int mt = it / n_nt, c = (it % n_nt) * 8 + 2 * tq;
        const float2 ac = ld_f2<kResident>((kResident ? R.a_c : p.a_c) + c);
        const float2 bc = ld_f2<kResident>((kResident ? R.b_c : p.b_c) + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = mt * 16 + g + 8 * h;
          if (q >= L.nc) continue;
          const int tx = q % tile, ty = (q / tile) % tile, f = t0 + q / (tile * tile) - f0;
          uint32_t* xr = reinterpret_cast<uint32_t*>(
              kSplit ? xt + q * sx + c : xt + ((f * hw + ty + 1) * hw + tx + 1) * sx + c);
          const float2 res = c3d::unpack_bf16x2(*xr);
          *xr = c3d::pack_bf16x2(fmaxf(acc[j][2 * h] * ac.x + bc.x + res.x, 0.f),
                                 fmaxf(acc[j][2 * h + 1] * ac.y + bc.y + res.y, 0.f));
        }
      }
    }
    tile_sync<kResident>(group);
    C3D_PHASE(6);
    // 16-byte stores of the output pixels inside the image.
    bf16* og = static_cast<bf16*>(p.out) + (size_t)b * sample;
    const int c8 = C / 8;
    for (int e = tid; e < L.nc * c8; e += kThreads) {
      const int j = e % c8, q = e / c8;
      const int tx = q % tile, ty = (q / tile) % tile, gt = t0 + q / (tile * tile);
      const int gy = y0 + ty, gx = x0 + tx;
      if (!P.has_frame(gt, T) || gy >= H || gx >= W) continue;
      *reinterpret_cast<uint4*>(og + (((size_t)gt * H + gy) * W + gx) * C + j * 8) =
          *reinterpret_cast<const uint4*>(
              kSplit ? xt + q * sx + j * 8
                     : xt + (((gt - f0) * hw + ty + 1) * hw + tx + 1) * sx + j * 8);
    }
    C3D_PHASE(7);
    // A resident group's next tile overwrites the x tile read above.
    if constexpr (kResident) tile_sync<true>(group);
  }
}

// The staged design: a block per (tile, sample), two blocks per SM.
template <bool kSums, int kAcc, int kXg, bool kTTiled>
__global__ void __launch_bounds__(kThreads, 2) fused_block_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_tile<kSums, kAcc, kXg, kTTiled, false>(p, smem, Resident{}, blockIdx.y, blockIdx.x,
                                               gridDim.x, threadIdx.x, 0);
}

// The split design's tail (T-tiled plans): the staged grid and tiles, xa
// from the xa pass (Params::xa). kTile: the tile side where it is 4 (every
// T-tiled X3D stage), fixed at compile time as in the resident design, else 0.
template <bool kSums, int kAcc, int kXg, int kTile>
__global__ void __launch_bounds__(kThreads, 2) fused_block_xa_tail_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_tile<kSums, kAcc, kXg, true, false, kTile, true>(p, smem, Resident{}, blockIdx.y,
                                                         blockIdx.x, gridDim.x, threadIdx.x, 0);
}

// The split design's xa pass: xa = round(relu(x @ w_a * a_a + b_a)) at every
// position, [B*T*H*W, round_up(Ci, 8)] bf16 (zeros in the channels from Ci
// on, so that every row is whole 16-byte units) into Params::out. A block
// takes kXaRows positions, copies their x rows once and walks Ci in slabs
// of kXaCols channels, each warp 16 rows x 8 n8 tiles of a slab; the next
// slab's w_a columns are copied while this slab's epilogue runs. Copies by
// 16-byte cp.async (4-byte where Ci is not a multiple of 8; zeros in the K
// padding, past the last position and past Ci). conv_a as the tile
// computes it: fp32 accumulators from 0, K in 16s from 0 over the
// zero-padded pad16(C), then BN_a, ReLU and the bf16 rounding, so xa holds
// the values the tile would have made. Each slab's output goes through
// shared memory to 16-byte stores.
constexpr int kXaN8 = kXaCols / 8;

// w_a's columns col0 .. col0 + kXaCols as [k][n] rows of stride sb.
__device__ __forceinline__ void xa_columns(bf16* ws, const bf16* wa, const XaLayout& X, int C,
                                           int Ci, int col0, int tid) {
  if (Ci % 8 == 0) {
    for (int e = tid; e < X.kp * kXaN8; e += kThreads) {
      const int j = e % kXaN8, k = e / kXaN8;
      uint4* dst = reinterpret_cast<uint4*>(ws + k * X.sb + j * 8);
      if (k < C && col0 + j * 8 < Ci)
        c3d::cp_async16(dst, wa + (size_t)k * Ci + col0 + j * 8);
      else
        *dst = make_uint4(0, 0, 0, 0);
    }
  } else {
    constexpr int n2 = kXaCols / 2;
    for (int e = tid; e < X.kp * n2; e += kThreads) {
      const int j = e % n2, k = e / n2;
      uint32_t* dst = reinterpret_cast<uint32_t*>(ws + k * X.sb + j * 2);
      if (k < C && col0 + j * 2 < Ci)
        c3d::cp_async4(dst, wa + (size_t)k * Ci + col0 + j * 2);
      else
        *dst = 0u;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) fused_block_xa_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  C3D_PHASE(0);
  const int C = p.C, Ci = p.Ci, cis = round_up(Ci, 8);
  const XaLayout X(C);
  const long long rows = (long long)p.B * p.T * p.H * p.W;
  const long long row0 = (long long)blockIdx.x * kXaRows;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + X.off_w);
  bf16* os = reinterpret_cast<bf16*>(smem + X.off_o);
  const bf16* xg = static_cast<const bf16*>(p.x);
  const bf16* wa = static_cast<const bf16*>(p.w_a);
  bf16* xa = static_cast<bf16*>(p.out);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  {
    const int c8 = C / 8, s8 = X.kp / 8;
    for (int e = tid; e < kXaRows * s8; e += kThreads) {
      const int j = e % s8, r = e / s8;
      uint4* dst = reinterpret_cast<uint4*>(xs + r * X.sx + j * 8);
      if (j < c8 && row0 + r < rows)
        c3d::cp_async16(dst, xg + (size_t)(row0 + r) * C + j * 8);
      else
        *dst = make_uint4(0, 0, 0, 0);
    }
  }
  xa_columns(ws, wa, X, C, Ci, 0, tid);
  const bf16* a0 = xs + (warp * 16 + g) * X.sx + 2 * tq;
  const bf16* a1 = a0 + 8 * X.sx;
  // Lane l addresses row k0 + l % 16 of n8 tile l / 16 (+ j): two n8
  // tiles' b fragments per ldmatrix.x4.
  const bf16* br = ws + (lane & 15) * X.sb + (lane >> 4) * 8;
  for (int col0 = 0; col0 < cis; col0 += kXaCols) {
    c3d::cp_async_wait_all();
    __syncthreads();  // this slab's columns landed; the last slab's stores read os
    if (col0 == 0) C3D_PHASE(1);
    float d[kXaN8][4];
#pragma unroll
    for (int j = 0; j < kXaN8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    for (int k0 = 0; k0 < X.kp; k0 += 16) {
      const uint32_t a[4] = {ld32(a0 + k0), ld32(a1 + k0), ld32(a0 + k0 + 8), ld32(a1 + k0 + 8)};
#pragma unroll
      for (int j = 0; j < kXaN8; j += 2) {
        uint32_t bq[4];
        c3d::ldmatrix_x4_trans(bq, br + k0 * X.sb + j * 8);
        c3d::mma_bf16_16816(d[j], a, bq[0], bq[1]);
        c3d::mma_bf16_16816(d[j + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this slab's columns
    if (col0 == 0) C3D_PHASE(2);
    if (col0 + kXaCols < cis) xa_columns(ws, wa, X, C, Ci, col0 + kXaCols, tid);
#pragma unroll
    for (int j = 0; j < kXaN8; ++j) {
      const int k = j * 8 + 2 * tq;  // the slab's channels of d[j][2h], d[j][2h+1]
      float2 aa = make_float2(0.f, 0.f), ba = make_float2(0.f, 0.f);
      if (col0 + k < Ci) {
        aa = __ldg(reinterpret_cast<const float2*>(p.a_a + col0 + k));
        ba = __ldg(reinterpret_cast<const float2*>(p.b_a + col0 + k));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(os + (warp * 16 + g + 8 * h) * X.so + k) =
            c3d::pack_bf16x2(fmaxf(d[j][2 * h] * aa.x + ba.x, 0.f),
                             fmaxf(d[j][2 * h + 1] * aa.y + ba.y, 0.f));
    }
    __syncthreads();
    for (int e = tid; e < kXaRows * kXaN8; e += kThreads) {
      const int j = e % kXaN8, r = e / kXaN8;
      if (row0 + r < rows && col0 + j * 8 < cis)
        *reinterpret_cast<uint4*>(xa + (size_t)(row0 + r) * cis + col0 + j * 8) =
            *reinterpret_cast<const uint4*>(os + r * X.so + j * 8);
    }
  }
  C3D_PHASE(3);
}

// The weight-resident design (one T-tile, kResidentTile x kResidentTile
// tiles): at most one block per SM, of kGroups groups of kThreads threads. The block copies w_a and
// (fwd) w_c into shared memory once, then each group walks the (sample,
// tile) items group, group + groups, ... of the launch (groups counted over
// the grid), one tile at a time under its own named barrier, while the
// other group's tile hides its latencies.
template <bool kSums, int kAcc>
__global__ void __launch_bounds__(kGroups * kThreads, 1) fused_block_resident_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  C3D_PHASE(8);
  const int C = p.C, Ci = p.Ci;
  const ResidentLayout RL(p.T, kResidentTile, C, Ci, p.ck);
  bf16* wa_s = reinterpret_cast<bf16*>(smem);
  bf16* wc_s = reinterpret_cast<bf16*>(smem + RL.off_wc);
  float* vec = reinterpret_cast<float*>(smem + RL.off_vec[kSums]);
  const Resident R{wa_s,           wc_s,           RL.sa,          RL.sc,
                   vec,            vec + Ci,       vec + 2 * Ci,   vec + 3 * Ci,
                   vec + 4 * Ci,   vec + 4 * Ci + C};
  {
    // 16-byte cp.async per 8 channels of a row; zero rows past C (w_a's K
    // padding) and past Ci (w_c's rows that a last, narrower chunk reads).
    const bf16* wa = static_cast<const bf16*>(p.w_a);
    const bf16* wc = static_cast<const bf16*>(p.w_c);
    const int a8 = Ci / 8, c8 = C / 8;
    for (int e = threadIdx.x; e < round_up(C, 16) * a8; e += blockDim.x) {
      const int k = e / a8, j = e % a8;
      uint4* dst = reinterpret_cast<uint4*>(wa_s + k * R.sa + j * 8);
      if (k < C)
        c3d::cp_async16(dst, wa + (size_t)k * Ci + j * 8);
      else
        *dst = make_uint4(0, 0, 0, 0);
    }
    if (!kSums)
      for (int e = threadIdx.x; e < RL.rows_c * c8; e += blockDim.x) {
        const int k = e / c8, j = e % c8;
        uint4* dst = reinterpret_cast<uint4*>(wc_s + k * R.sc + j * 8);
        if (k < Ci)
          c3d::cp_async16(dst, wc + (size_t)k * C + j * 8);
        else
          *dst = make_uint4(0, 0, 0, 0);
      }
    for (int e = threadIdx.x; e < Ci; e += blockDim.x) {
      vec[e] = p.a_a[e];
      vec[Ci + e] = p.b_a[e];
      vec[2 * Ci + e] = p.a_b[e];
      vec[3 * Ci + e] = p.b_b[e];
    }
    if (!kSums)
      for (int e = threadIdx.x; e < C; e += blockDim.x) {
        vec[4 * Ci + e] = p.a_c[e];
        vec[4 * Ci + C + e] = p.b_c[e];
      }
    c3d::cp_async_wait_all();
    __syncthreads();
  }
  C3D_PHASE(9);
  const int group = threadIdx.x / kThreads;
  unsigned char* tile_smem = smem + RL.off_tiles[kSums] +
                             group * (kSums ? RL.tile.bytes_sums : RL.tile.bytes_fwd);
  constexpr int kTile = kResidentTile;
  const int n_tiles = ((p.H + kTile - 1) / kTile) * ((p.W + kTile - 1) / kTile);
  for (int item = blockIdx.x * kGroups + group; item < p.B * n_tiles;
       item += gridDim.x * kGroups)
    bf16_tile<kSums, kAcc, kTile, false, true, kTile>(p, tile_smem, R, item / n_tiles,
                                                      item % n_tiles, n_tiles,
                                                      threadIdx.x % kThreads, group);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

using KernelFn = void (*)(Params);

// The kernel instantiation for a call, or null if the call is not one the
// kernels take (the bf16 layout's byte count must match `smem`).
template <bool kTTiled>
KernelFn pick_kernel(int dtype, bool sums, const Params& p, int smem) {
  if (dtype == 0)
    return sums ? fused_block_f32_kernel<true, kTTiled> : fused_block_f32_kernel<false, kTTiled>;
  if (dtype != 1) return nullptr;
  const Bf16Layout L(p.T, p.tt, p.tile, p.C, p.ck);
  if (p.C % 8 != 0 || p.Ci % 2 != 0 || p.ck % 2 != 0 || p.tile % 4 != 0 ||
      smem != (sums ? L.bytes_sums : L.bytes_fwd))
    return nullptr;
  // Eight outputs per tap thread where the tile allows and the registers are
  // not held by 16 accumulator tiles.
  const bool wide = p.tile % 8 == 0;
  if (sums)
    return wide ? fused_block_bf16_kernel<true, 1, 8, kTTiled>
                : fused_block_bf16_kernel<true, 1, 4, kTTiled>;
  const int per_warp = ((L.ncp / 16) * (p.C / 8) + kWarps - 1) / kWarps;
  if (per_warp <= 8)
    return wide ? fused_block_bf16_kernel<false, 8, 8, kTTiled>
                : fused_block_bf16_kernel<false, 8, 4, kTTiled>;
  if (per_warp <= 16) return fused_block_bf16_kernel<false, 16, 4, kTTiled>;
  return nullptr;
}

// The weight-resident instantiation: bf16, one T-tile of kResidentTile
// tiles, at most 8 conv_c accumulator tiles a warp, C, Ci and ck multiples
// of 8 (16-byte rows), and ResidentLayout's byte count.
KernelFn pick_resident(int dtype, bool sums, const Params& p, int smem) {
  const ResidentLayout RL(p.T, p.tile, p.C, p.Ci, p.ck);
  const int per_warp = ((RL.tile.ncp / 16) * (p.C / 8) + kWarps - 1) / kWarps;
  if (dtype != 1 || p.tt != p.T || p.tile != kResidentTile || per_warp > 8 || p.C % 8 != 0 ||
      p.Ci % 8 != 0 || p.ck % 8 != 0 || smem != (sums ? RL.bytes_sums : RL.bytes_fwd))
    return nullptr;
  return sums ? fused_block_resident_kernel<true, 1> : fused_block_resident_kernel<false, 8>;
}

// The split design's tail: bf16, T-tiles shorter than the clip, C a
// multiple of 8 and Ci of 2, chunks that start at a multiple of 8 channels
// (16-byte copies), and SplitLayout's byte count.
KernelFn pick_split(int dtype, bool sums, const Params& p, int smem) {
  const SplitLayout S(p.T, p.tt, p.tile, p.C, p.ck);
  if (dtype != 1 || p.tt >= p.T || p.C % 8 != 0 || p.Ci % 2 != 0 ||
      (p.ck % 8 != 0 && p.ck < p.Ci) || p.tile % 4 != 0 ||
      smem != (sums ? S.bytes_sums : S.bytes_fwd))
    return nullptr;
  const bool wide = p.tile % 8 == 0, four = p.tile == 4;
  if (sums)
    return wide ? fused_block_xa_tail_kernel<true, 1, 8, 0>
                : four ? fused_block_xa_tail_kernel<true, 1, 4, 4> : nullptr;
  const int per_warp = ((S.g.ncp / 16) * (p.C / 8) + kWarps - 1) / kWarps;
  if (per_warp <= 8)
    return wide ? fused_block_xa_tail_kernel<false, 8, 8, 0>
                : four ? fused_block_xa_tail_kernel<false, 8, 4, 4> : nullptr;
  if (per_warp <= 16)
    return four ? fused_block_xa_tail_kernel<false, 16, 4, 4>
                : fused_block_xa_tail_kernel<false, 16, 4, 0>;
  return nullptr;
}

// The designs, as ops/fused_block.py passes them.
enum Design { kStaged = 0, kResidentDesign = 1, kSplitDesign = 2 };

KernelFn pick_kernel(int dtype, bool sums, const Params& p, int smem, int design) {
  if (p.tt < 1 || p.tt > p.T) return nullptr;
  if (design == kResidentDesign) return pick_resident(dtype, sums, p, smem);
  if (design == kSplitDesign) return pick_split(dtype, sums, p, smem);
  if (design != kStaged) return nullptr;
  return p.tt < p.T ? pick_kernel<true>(dtype, sums, p, smem)
                    : pick_kernel<false>(dtype, sums, p, smem);
}

cudaError_t set_attributes(KernelFn kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // All of L1 that can be shared memory, so that two blocks (or one
  // resident block) fit an SM.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

int launch(int dtype, bool sums, const Params& p, int smem, int design, void* stream) {
  KernelFn kernel = pick_kernel(dtype, sums, p, smem, design);
  if (kernel == nullptr || (design == kSplitDesign && p.xa == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((p.T + p.tt - 1) / p.tt) * ((p.H + p.tile - 1) / p.tile) *
                    ((p.W + p.tile - 1) / p.tile);
  if (design == kResidentDesign) {
    // Persistent: one block per SM of the current card (the caller makes x's
    // card current), fewer where the items do not fill them.
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    const int groups_needed = (p.B * tiles + kGroups - 1) / kGroups;
    const int blocks = groups_needed < sms ? groups_needed : sms;
    kernel<<<blocks, kGroups * kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  } else {
    dim3 grid(tiles, p.B);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return (int)cudaGetLastError();
}

Params make_params(const void* x, const void* w_a, const void* a_a, const void* b_a,
                   const void* w_dw, const void* a_b, const void* b_b, int B, int T, int H,
                   int W, int C, int Ci, int tt, int tile, int ck) {
  Params p{};
  p.x = x;
  p.w_a = w_a;
  p.a_a = static_cast<const float*>(a_a);
  p.b_a = static_cast<const float*>(b_a);
  p.w_dw = static_cast<const float*>(w_dw);
  p.a_b = static_cast<const float*>(a_b);
  p.b_b = static_cast<const float*>(b_b);
  p.T = T; p.H = H; p.W = W; p.C = C; p.Ci = Ci; p.tile = tile; p.ck = ck; p.tt = tt; p.B = B;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; design: 0 staged, 1 weight-resident, 2
// the split design's tail, which reads xa (the xa pass's output; null
// otherwise) (ops/fused_block.py:plan_block decides). Returns a cudaError_t
// (0 on success).
extern "C" int c3d_fused_block_fwd(int dtype, const void* x, void* out, const void* w_a,
                                   const void* a_a, const void* b_a, const void* w_dw,
                                   const void* a_b, const void* b_b, const void* gate,
                                   const void* w_c, const void* a_c, const void* b_c, int B,
                                   int T, int H, int W, int C, int Ci, int tt, int tile,
                                   int ck, int smem, int design, const void* xa, void* stream) {
  Params p = make_params(x, w_a, a_a, b_a, w_dw, a_b, b_b, B, T, H, W, C, Ci, tt, tile, ck);
  p.out = out;
  p.gate = static_cast<const float*>(gate);
  p.w_c = w_c;
  p.a_c = static_cast<const float*>(a_c);
  p.b_c = static_cast<const float*>(b_c);
  p.xa = xa;
  return launch(dtype, false, p, smem, design, stream);
}

extern "C" int c3d_fused_block_se_sums(int dtype, const void* x, void* sums, const void* w_a,
                                       const void* a_a, const void* b_a, const void* w_dw,
                                       const void* a_b, const void* b_b, int B, int T, int H,
                                       int W, int C, int Ci, int tt, int tile, int ck, int smem,
                                       int design, const void* xa, void* stream) {
  Params p = make_params(x, w_a, a_a, b_a, w_dw, a_b, b_b, B, T, H, W, C, Ci, tt, tile, ck);
  p.sums = static_cast<float*>(sums);
  p.xa = xa;
  return launch(dtype, true, p, smem, design, stream);
}

// The split design's xa pass (bf16): xa [B,T,H,W,round_up(Ci, 8)] from x,
// w_a and BN_a; C a multiple of 8 and Ci of 2, smem XaLayout's byte count.
extern "C" int c3d_fused_block_xa(const void* x, void* xa, const void* w_a, const void* a_a,
                                  const void* b_a, int B, int T, int H, int W, int C, int Ci,
                                  int smem, void* stream) {
  Params p = make_params(x, w_a, a_a, b_a, nullptr, nullptr, nullptr, B, T, H, W, C, Ci, T, 4,
                         Ci);
  p.out = xa;
  const long long blocks = ((long long)B * T * H * W + kXaRows - 1) / kXaRows;
  if (C % 8 != 0 || Ci % 2 != 0 || smem != XaLayout(C).bytes || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes(fused_block_xa_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    fused_block_xa_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        p);
  return (int)cudaGetLastError();
}

// Blocks of the chosen kernel that fit one SM at once (occupancy), or -1 if
// the kernels do not take the call.
extern "C" int c3d_fused_block_blocks_per_sm(int dtype, int se_sums, int T, int tt, int C,
                                             int Ci, int tile, int ck, int smem, int design) {
  Params p{};
  p.T = T; p.tt = tt; p.C = C; p.Ci = Ci; p.tile = tile; p.ck = ck;
  KernelFn kernel = pick_kernel(dtype, se_sums != 0, p, smem, design);
  if (kernel == nullptr || set_attributes(kernel, smem) != cudaSuccess) return -1;
  int n = -1;
  const int threads = design == kResidentDesign ? kGroups * kThreads : kThreads;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}

extern "C" const char* c3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
