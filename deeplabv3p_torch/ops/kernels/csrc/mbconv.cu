// Stride-1 MobileNetV2 inverted residual in one pass (inference).
//
// Replaces the Pallas TPU kernel deeplabv3p_tpu/ops/pallas/mbconv.py:
// fused_inverted_residual (body `_kernel`):
//   e = bf16(relu6((x @ we) * se + be))                      expand 1x1 + BN
//   d = bf16(relu6(dw3x3(e, wd, dilation=rate, SAME) * sd + bd))
//   y = (d @ wp) * sp + bp  (+ x)                            project 1x1 + BN
// with the 6x-expanded tensors e and d never in device memory. Both 1x1
// products are computed here, in the kernel's body, on the tensor cores.
//
// Bound: operations. At the eval path's 13 block shapes (batch 8, 512x512,
// OS16) a block reads x and writes y once, 2.3-12.6 MB, against 0.86-7.7
// GFLOP: far above the ridge. The two products (31.5 GFLOP for the 13 calls)
// are reckoned at the dense bf16 tensor-core rate (989 TFLOP/s), the
// depthwise stencil (0.5 GFLOP) at the f32 FMA rate (67 TFLOP/s): 1.7 us
// (blocks 7-9) to 9.7 us (block 16), 52.8 us for the 13 calls. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: 1.03 ms for the 13 calls by CUDA events
// (0.95 ms of device time; 37 us to 146 us each), 0.05 of that bound, where
// the scalar-FMA kernel before it took 6.3 ms (PERF.md has the table).
//
// The weights stay f32-exact. They are f32 in the Pallas kernel's signature
// and in the plain version, and rounding them to bf16 alone leaves the
// tolerance at the widest block. So each of `we` and `wp` is split once, on
// the host side (ops/kernels/mbconv.py: split_bf16), into a bf16 high part
// and a bf16 low part, and the kernel runs one tensor-core product for
// each part on the same activation fragments; the sum carries 16 bits of the
// weight. A bf16 x is exact as it is; an f32 x is split the same way while it
// is staged, and its low part meets the weights' high part in a third
// product. The residual add reads the unrounded x from device memory.
//
// Design. One block owns an 8x8 output tile of one image and walks Cexp in
// chunks of 32 channels (16 where shared memory is short: OS8's rate 4 with
// an f32 x). What the TPU version does for the TPU's sake is dropped: the
// input passed three times with clamped index maps, the padding of Cexp to
// 128 lanes in device memory, the 8 MB VMEM tile rule.
// * x tile with its `rate` halo, (8+2r)^2 pixels padded to 16-row tiles, K =
//   Cin padded to 16, staged once as bf16 in shared memory (zeros outside
//   the image and in the padding, so a padded row or K column adds exactly 0).
// * A chunk's weights are one contiguous block of bytes in device memory,
//   laid out by the host as the fragment loads want them: an expand part (we
//   transposed, K contiguous, hi then lo; se, be) and a project part (wp
//   transposed, hi then lo; wd, sd, bd), zero-padded, so Cexp = 144 needs no
//   padding of the tensors in device memory and no live-lane logic here. Both
//   arrive by cp.async into one of two buffers, each part as soon as its
//   buffer's last reader has passed a barrier: the project part one chunk
//   ahead, the expand part two. Every weight the loops read comes from shared
//   memory.
// * expand: `mma.sync.m16n8k16` (bf16 in, f32 accumulate), A = 16 halo pixels
//   x K from the x tile, B = 16 expanded channels x K, both by `ldmatrix`
//   from rows whose pitch is an odd number of 16-byte units (no bank
//   conflicts); one load brings a B tile's hi and lo fragments, which
//   accumulate in chains of their own. A warp takes units of (one or two
//   16-pixel tiles) x (16 channels); BN + relu6 in f32 on the accumulators,
//   ZERO for halo pixels outside the image (the depthwise conv's SAME padding
//   lives in E-space: a zero input row would give relu6(be) != 0; which rows
//   lie inside is reckoned once a block, not once a chunk), bf16 into the
//   shared e tile.
// * depthwise: a thread owns two neighbouring channels (its 9 taps and BN
//   fold in registers, read once a chunk from shared memory) and walks the
//   64 pixels in steps; bf16 into the shared d tile.
// * project: the 64 x Cout f32 accumulators live in registers across all
//   chunks, WM (groups of 16-pixel tiles) x 4 (quarters of Cout) warps, NT
//   tiles of 8 channels a warp (templates: Cout pads to 32, 64, 96, 160,
//   320); A = d tile, B = the chunk's wp rows, hi then lo.
// * Two barriers a chunk (after expand, after depthwise) and none between one
//   chunk's project and the next chunk's expand: a warp that has finished its
//   share of the project product starts expanding the next chunk while other
//   warps still multiply, so tensor-core and CUDA-core work of different
//   warps overlap inside the one block an SM holds on the 32x32 maps.
// * epilogue: project BN fold, residual add from x in device memory, f32,
//   one rounding to x's type.
// Why `mma.sync` and not `wgmma`: the expand product's M is the halo (100,
// 144 or 256 pixels, not multiples of 64) and its result must pass through
// BN + relu6 + the image mask in registers before the stencil can read it,
// and the project product's A tile is written by CUDA cores chunk by chunk;
// warp-level tiles need no 128-byte swizzled layouts and descriptors, and
// each warp runs on as soon as its own fragments are there. The price: every
// fragment passes through `ldmatrix`, 150-380 bytes of shared-memory reads an
// mma with the hi and lo parts, so the kernel is bound by shared-memory
// bandwidth and by its CUDA-core stages (stencil, BN folds, staging), not by
// the tensor cores' rate. `wgmma` with B read by the tensor cores straight
// from shared memory is the later lever.
// Occupancy (ptxas and cudaOccupancyMaxActiveBlocksPerMultiprocessor, printed
// by chip_smoke.py), bf16 x: Cout <= 96 runs 256 threads a block, 116-128
// registers, two blocks an SM at 47-98 KB of shared memory; Cout 160 and 320
// run 512 threads, 118-128 registers (36 bytes spilled at Cout 320), one
// block an SM at 119-214 KB. On the 32x32
// maps the grid has 128 blocks for 132 SMs either way.

#include "common.cuh"

namespace dlk {

constexpr int kTile = 8;            // output tile side
constexpr int kExpandFoldRows = 2;    // f32 rows of a chunk's expand part: se, be
constexpr int kProjectFoldRows = 11;  // ... of its project part: the 9 taps of wd, sd, bd
constexpr int kMbconvMaxSmem = 232448;  // 227 KB a block on sm_90

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, K-contiguous)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Shared-memory plan of a block, in bytes; the same arithmetic as
// ops/kernels/mbconv.py (KernelConfig, kernel_config).
struct MbLayout {
  int hp;           // halo pixels, (8 + 2 rate)^2
  int rows;         // ... padded to the 16-row tensor-core tiles
  int kpad;         // Cin padded to 16
  int x_stride;     // bytes of a row of kpad bf16: 16 bytes of padding make it an odd
                    // number of 16-byte units
  int e_stride;     // bytes of a row of `chunk` bf16, padded the same way
  int cout_pad;     // 32 * NT
  int e_bytes;      // a chunk's expand part: we hi, we lo, se, be
  int p_bytes;      // ... and the rest: wp hi, wp lo, the 9 taps of wd, sd, bd
  int chunk_bytes;  // both
  int total;
};

__host__ __device__ inline MbLayout mb_layout(int rate, int cin, int nt, int chunk, int stages,
                                              int x_parts) {
  MbLayout l;
  const int side = kTile + 2 * rate;
  l.hp = side * side;
  l.rows = (l.hp + 15) / 16 * 16;
  l.kpad = (cin + 15) / 16 * 16;
  l.x_stride = 2 * l.kpad + 16;
  l.e_stride = 2 * chunk + 16;
  l.cout_pad = 32 * nt;
  l.e_bytes = 2 * chunk * l.x_stride + kExpandFoldRows * chunk * 4;
  l.p_bytes = 2 * l.cout_pad * l.e_stride + kProjectFoldRows * chunk * 4;
  l.chunk_bytes = l.e_bytes + l.p_bytes;
  l.total = x_parts * l.rows * l.x_stride + (l.rows + kTile * kTile) * l.e_stride +
            stages * l.chunk_bytes;
  return l;
}

// four channels of a pixel into the staged tile: bf16 as it is
__device__ __forceinline__ void stage4(const __nv_bfloat16* src, unsigned char* hi,
                                       unsigned char*) {
  *reinterpret_cast<uint2*>(hi) = *reinterpret_cast<const uint2*>(src);
}
// ... f32 as a bf16 high part and the bf16 of what it leaves
__device__ __forceinline__ void stage4(const float* src, unsigned char* hi, unsigned char* lo) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  const float f[4] = {v.x, v.y, v.z, v.w};
  float h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __bfloat162float(__float2bfloat16(f[i]));
    l[i] = f[i] - h[i];
  }
  *reinterpret_cast<uint2*>(hi) = make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
  *reinterpret_cast<uint2*>(lo) = make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
}

// WM warps along the tile's 64 pixels (2 or 4) times 4 along Cout.
template <typename T, int NT, int WM>
__global__ void __launch_bounds__(WM * 128)
mbconv_kernel(const T* __restrict__ x,                 // (N,H,W,Cin)
              const unsigned char* __restrict__ prep,  // chunks, then sp and bp (mbconv.py)
              T* __restrict__ out,                     // (N,H,W,Cout)
              int h, int w, int cin, int cexp, int cout, int rate, int residual, int chunk,
              int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kSplitX = sizeof(T) == 4;
  constexpr int kXParts = kSplitX ? 2 : 1;
  constexpr int kWarps = WM * 4, kThreads = kWarps * 32;
  constexpr int MI = 4 / WM;  // 16-pixel tiles of the output a warp owns
  // 16-pixel tiles an expand unit may take: one keeps the 8-warp block's
  // registers low enough for three blocks an SM
  constexpr int kMaxPer = WM == 2 ? 1 : 2;
  const MbLayout L = mb_layout(rate, cin, NT, chunk, stages, kXParts);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int side = kTile + 2 * rate;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w;
  const int nch = (cexp + chunk - 1) / chunk;

  unsigned char* xs = smem;                                   // x tile: hi (then lo)
  const int x_lo_off = L.rows * L.x_stride;                   // hi -> lo, where x is split
  unsigned char* es = smem + kXParts * L.rows * L.x_stride;   // e tile (rows, chunk)
  unsigned char* ds = es + L.rows * L.e_stride;               // d tile (64, chunk)
  unsigned char* wst = ds + kTile * kTile * L.e_stride;       // weight buffers

  // a chunk's expand part or project part, into the chunk's buffer
  auto load_part = [&](int c, int offset, int bytes) {
    const unsigned char* src = prep + static_cast<size_t>(c) * L.chunk_bytes + offset;
    const uint32_t dst = smem_u32(wst + (c % stages) * L.chunk_bytes + offset);
    for (int o = tid * 16; o < bytes; o += kThreads * 16) cp_async16(dst + o, src + o);
  };
  auto load_e = [&](int c) { load_part(c, 0, L.e_bytes); };
  auto load_p = [&](int c) { load_part(c, L.e_bytes, L.p_bytes); };
  auto inside = [&](int p) {  // halo pixel p lies in the image
    const int hy = p / side, hx = p - hy * side;
    const int gy = y0 - rate + hy, gx = x0 - rate + hx;
    return p < L.hp && gy >= 0 && gy < h && gx >= 0 && gx < w;
  };

  if (stages == 2) {
    load_e(0);
    load_p(0);
    if (nch > 1) load_e(1);
    cp_async_commit();
  }

  // stage the input tile and its halo, 4 channels a thread a step
  {
    const int units = L.kpad / 4;
    for (int v = tid; v < L.rows * units; v += kThreads) {
      const int p = v / units;
      const int k = (v - p * units) * 4;
      unsigned char* hi = xs + p * L.x_stride + k * 2;
      if (k < cin && inside(p)) {
        const int hy = p / side, hx = p - hy * side;
        const size_t px = image + static_cast<size_t>(y0 - rate + hy) * w + (x0 - rate + hx);
        stage4(x + px * cin + k, hi, hi + x_lo_off);
      } else {
        *reinterpret_cast<uint2*>(hi) = make_uint2(0u, 0u);
        if (kSplitX) *reinterpret_cast<uint2*>(hi + x_lo_off) = make_uint2(0u, 0u);
      }
    }
  }

  // project accumulators; narrow outputs keep the low weight part's sums apart,
  // for two independent chains of tensor-core instructions a tile
  constexpr int kAccParts = NT <= 3 ? 2 : 1;
  float acc[kAccParts][MI][NT][4];
#pragma unroll
  for (int part = 0; part < kAccParts; ++part)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[part][mi][t][i] = 0.f;

  const int mq = warp % WM, nq = warp / WM;  // project: group of pixel tiles, quarter of Cout
  const int ksteps = L.kpad / 16;
  const int n16 = chunk / 16;

  // expand units: `per` 16-pixel tiles (two where the tiles outnumber the warps)
  // x 16 channels; a warp takes units warp, warp + kWarps, ... of every chunk,
  // so which of its rows lie in the image is reckoned once, a bit a row group
  const int mtiles = L.rows / 16;
  const int per = min(kMaxPer, (mtiles * n16 + kWarps - 1) / kWarps);
  const int units = (mtiles + per - 1) / per * n16;
  constexpr int kMaskRounds = 8;
  uint32_t in_mask = 0;
  for (int r = 0; r < kMaskRounds; ++r) {
    const int u = warp + r * kWarps;
    if (u >= units) break;
    const int p0 = (u / n16) * per * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < 2 * kMaxPer; ++q)  // tile q / 2 of the unit, rows p0 + 8 (q % 2)
      if ((q < 2 || per == 2) && inside(p0 + q * 8)) in_mask |= 1u << (r * 4 + q);
  }

  if (stages == 2) cp_async_wait_all();
  __syncthreads();  // the x tile and the first weights are in shared memory

  for (int c = 0; c < nch; ++c) {
    if (stages == 1) {  // one buffer: the chunk loads when every warp has left the last one
      __syncthreads();
      load_e(c);
      load_p(c);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    const unsigned char* wc = wst + (c % stages) * L.chunk_bytes;
    const float* efolds = reinterpret_cast<const float*>(wc + 2 * chunk * L.x_stride);
    const unsigned char* wpc = wc + L.e_bytes;
    const float* pfolds = reinterpret_cast<const float*>(wpc + 2 * L.cout_pad * L.e_stride);

    // -- expand 1x1 + BN + relu6 over the halo tile ----------------------------
    // (no barrier above: a warp that has left chunk c-1's project starts here
    // while others still run it; the e tile's readers passed the last barrier)
    for (int u = warp, r = 0; u < units; u += kWarps, ++r) {
      const int group = u / n16, nh = u - group * n16;
      const int mt = group * per;
      const bool two = per == 2 && mt + 1 < mtiles;  // the same for the whole warp
      float ea[kMaxPer][2][2][4];  // [tile][8-channel tile][weight part][fragment]
#pragma unroll
      for (int g = 0; g < kMaxPer; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) ea[g][j][0][i] = ea[g][j][1][i] = 0.f;
      // A: lane -> row lane % 16 of the tile, K half lane / 16
      const uint32_t a_addr =
          smem_u32(xs) + (mt * 16 + (lane & 15)) * L.x_stride + (lane >> 4) * 16;
      // B: one load an 8-channel tile brings its hi and its lo fragments:
      // lane -> channel lane % 8, K half (lane / 8) % 2, part lane / 16
      const uint32_t b_addr = smem_u32(wc) + (lane >> 4) * (chunk * L.x_stride) +
                              (nh * 16 + (lane & 7)) * L.x_stride + ((lane >> 3) & 1) * 16;
#pragma unroll 2
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a[kMaxPer][4], al[kMaxPer][4];
#pragma unroll
        for (int g = 0; g < kMaxPer; ++g) {
          if (g == 1 && !two) break;
          ldmatrix_x4(a[g], a_addr + g * 16 * L.x_stride + ks * 32);
          if (kSplitX) ldmatrix_x4(al[g], a_addr + x_lo_off + g * 16 * L.x_stride + ks * 32);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, b_addr + j * 8 * L.x_stride + ks * 32);
#pragma unroll
          for (int g = 0; g < kMaxPer; ++g) {
            if (g == 1 && !two) break;
            mma_bf16(ea[g][j][0], a[g], b[0], b[1]);
            mma_bf16(ea[g][j][1], a[g], b[2], b[3]);
            if (kSplitX) mma_bf16(ea[g][j][1], al[g], b[0], b[1]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxPer; ++g) {
        if (g == 1 && !two) break;
        const int p0 = (mt + g) * 16 + (lane >> 2);
        bool in0, in1;
        if (r < kMaskRounds) {
          in0 = (in_mask >> (r * 4 + g * 2)) & 1u;
          in1 = (in_mask >> (r * 4 + g * 2 + 1)) & 1u;
        } else {
          in0 = inside(p0);
          in1 = inside(p0 + 8);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nh * 16 + j * 8 + 2 * (lane & 3);
          const float2 s = *reinterpret_cast<const float2*>(efolds + col);
          const float2 b = *reinterpret_cast<const float2*>(efolds + chunk + col);
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = ea[g][j][0][i] + ea[g][j][1][i];
          // outside the image e is zero: the depthwise conv's SAME padding
          const uint32_t v0 =
              in0 ? pack_bf16(relu6f(v[0] * s.x + b.x), relu6f(v[1] * s.y + b.y)) : 0u;
          const uint32_t v1 =
              in1 ? pack_bf16(relu6f(v[2] * s.x + b.x), relu6f(v[3] * s.y + b.y)) : 0u;
          *reinterpret_cast<uint32_t*>(es + p0 * L.e_stride + col * 2) = v0;
          *reinterpret_cast<uint32_t*>(es + (p0 + 8) * L.e_stride + col * 2) = v1;
        }
      }
    }
    // the loads started a chunk ago have landed: this chunk's project part and
    // the next chunk's expand part
    if (stages == 2) cp_async_wait_all();
    __syncthreads();
    // every warp has left chunk c-1's project and chunk c's expand: their
    // buffers take the next chunk's project part and the expand part after it
    if (stages == 2) {
      if (c + 1 < nch) load_p(c + 1);
      if (c + 2 < nch) load_e(c + 2);
      cp_async_commit();
    }

    // -- 3x3 depthwise (dilation `rate`) + BN + relu6 over the 8x8 tile ----------
    {
      const int pairs = chunk / 2;          // 16 or 8: divides the block
      const int ch = 2 * (tid % pairs);     // this thread's two channels, every step
      float2 wt[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wt[t] = *reinterpret_cast<const float2*>(pfolds + t * chunk + ch);
      const float2 s = *reinterpret_cast<const float2*>(pfolds + 9 * chunk + ch);
      const float2 b = *reinterpret_cast<const float2*>(pfolds + 10 * chunk + ch);
      for (int px = tid / pairs; px < kTile * kTile; px += kThreads / pairs) {
        const int py = px >> 3, pxx = px & 7;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int p = (py + dy * rate) * side + pxx + dx * rate;
            const uint32_t e = *reinterpret_cast<const uint32_t*>(es + p * L.e_stride + ch * 2);
            a0 = fmaf(bf16_lo(e), wt[dy * 3 + dx].x, a0);
            a1 = fmaf(bf16_hi(e), wt[dy * 3 + dx].y, a1);
          }
        *reinterpret_cast<uint32_t*>(ds + px * L.e_stride + ch * 2) =
            pack_bf16(relu6f(a0 * s.x + b.x), relu6f(a1 * s.y + b.y));
      }
    }
    __syncthreads();

    // -- project 1x1, accumulated over the chunks --------------------------------
    {
      const uint32_t a_addr =
          smem_u32(ds) + (mq * MI * 16 + (lane & 15)) * L.e_stride + (lane >> 4) * 16;
      const uint32_t b_addr = smem_u32(wpc) + (lane >> 4) * (L.cout_pad * L.e_stride) +
                              (nq * 8 * NT + (lane & 7)) * L.e_stride + ((lane >> 3) & 1) * 16;
      for (int ks = 0; ks < n16; ++ks) {
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(a[mi], a_addr + mi * 16 * L.e_stride + ks * 32);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t b[4];
          ldmatrix_x4(b, b_addr + t * 8 * L.e_stride + ks * 32);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[0][mi][t], a[mi], b[0], b[1]);
            mma_bf16(acc[kAccParts - 1][mi][t], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }
  // -- epilogue: project BN (+ residual) in f32, one rounding --------------------
  const float* sp = reinterpret_cast<const float*>(prep + static_cast<size_t>(nch) * L.chunk_bytes);
  const float* bp = sp + L.cout_pad;
  const bool pairwise = (cout & 1) == 0;  // then two neighbouring channels store as one word
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = nq * 8 * NT + t * 8 + 2 * (lane & 3);
    if (col >= cout) continue;
    const float s0 = sp[col], s1 = sp[col + 1], b0 = bp[col], b1 = bp[col + 1];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = (mq * MI + mi) * 16 + (lane >> 2) + half * 8;
        const int gy = y0 + (px >> 3), gx = x0 + (px & 7);
        if (gy >= h || gx >= w) continue;
        const size_t pixel = image + static_cast<size_t>(gy) * w + gx;
        float v0 = acc[0][mi][t][half * 2], v1 = acc[0][mi][t][half * 2 + 1];
        if (kAccParts == 2) {
          v0 += acc[kAccParts - 1][mi][t][half * 2];
          v1 += acc[kAccParts - 1][mi][t][half * 2 + 1];
        }
        v0 = v0 * s0 + b0;
        v1 = v1 * s1 + b1;
        const bool two = col + 1 < cout;
        if (residual) {
          v0 += to_f32(x[pixel * cin + col]);
          if (two) v1 += to_f32(x[pixel * cin + col + 1]);
        }
        T* dst = out + pixel * cout + col;
        if (pairwise) {
          store2(dst, v0, v1);
        } else {
          dst[0] = from_f32<T>(v0);
          if (two) dst[1] = from_f32<T>(v1);
        }
      }
  }
}

}  // namespace dlk

namespace {

// narrow outputs: 8 warps a block (more blocks an SM); wide ones: 16 warps
template <int NT> constexpr int warps_m() { return NT <= 3 ? 2 : 4; }

template <typename T, int NT>
int launch_mbconv(const void* x, const void* prep, void* out, int n, int h, int w, int cin,
                  int cexp, int cout, int rate, int residual, int chunk, int stages,
                  int smem_bytes, cudaStream_t s) {
  constexpr int WM = warps_m<NT>();
  auto kernel = dlk::mbconv_kernel<T, NT, WM>;
  const dlk::MbLayout layout = dlk::mb_layout(rate, cin, NT, chunk, stages, sizeof(T) == 4 ? 2 : 1);
  // the host side reckons the same plan: a mismatch is a bug, not a launch
  if (layout.total != smem_bytes || layout.total > dlk::kMbconvMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, layout.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks an SM as registers and shared memory allow
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + dlk::kTile - 1) / dlk::kTile, (h + dlk::kTile - 1) / dlk::kTile, n);
  kernel<<<grid, WM * 128, layout.total, s>>>(
      static_cast<const T*>(x), static_cast<const unsigned char*>(prep), static_cast<T*>(out), h,
      w, cin, cexp, cout, rate, residual, chunk, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int blocks_per_sm(int smem_bytes) {
  constexpr int WM = warps_m<NT>();
  auto kernel = dlk::mbconv_kernel<T, NT, WM>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
      cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WM * 128, smem_bytes) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// 8-channel tiles a warp owns: the MobileNetV2 widths 24/32, 64, 96, 160, 320
#define DLK_FOR_NT(nt, CALL) \
  if (nt <= 1) CALL(1);      \
  if (nt <= 2) CALL(2);      \
  if (nt <= 3) CALL(3);      \
  if (nt <= 5) CALL(5);      \
  if (nt <= 10) CALL(10)

template <typename T>
int dispatch_cout(const void* x, const void* prep, void* out, int n, int h, int w, int cin,
                  int cexp, int cout, int rate, int residual, int chunk, int stages,
                  int smem_bytes, cudaStream_t s) {
#define DLK_MBCONV(NT)                                                                          \
  return launch_mbconv<T, NT>(x, prep, out, n, h, w, cin, cexp, cout, rate, residual, chunk, \
                              stages, smem_bytes, s)
  DLK_FOR_NT((cout + 31) / 32, DLK_MBCONV);
#undef DLK_MBCONV
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_occupancy(int cout, int smem_bytes) {
#define DLK_OCC(NT) return blocks_per_sm<T, NT>(smem_bytes)
  DLK_FOR_NT((cout + 31) / 32, DLK_OCC);
#undef DLK_OCC
  return -1;
}

}  // namespace

// x/out are f32 (dtype 0) or bf16 (dtype 1), NHWC; `prep` is the blob of
// ops/kernels/mbconv.py:prepare_inverted_residual for the same chunk (32 or
// 16) and input type, `stages` its buffers in shared memory (1 or 2),
// `smem_bytes` the host's reckoning of the block's shared memory. Needs
// cin % 4 == 0 (16-byte staging), cout <= 320, 1 <= rate, n <= 65535.
// Launches on `stream` (of the current device) and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_inverted_residual(const void* x, const void* prep, void* out, int dtype,
                                       int n, int h, int w, int cin, int cexp, int cout,
                                       int rate, int residual, int chunk, int stages,
                                       int smem_bytes, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  if (cin <= 0 || cin % 4 != 0 || cexp <= 0 || cout <= 0 || rate < 1 || n > 65535 ||
      (h + dlk::kTile - 1) / dlk::kTile > 65535 || (residual && cin != cout) ||
      (chunk != 16 && chunk != 32) || (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLK_ARGS x, prep, out, n, h, w, cin, cexp, cout, rate, residual, chunk, stages, smem_bytes, s
  if (dtype == dlk::kFloat32)
    return dispatch_cout<float>(DLK_ARGS);
  if (dtype == dlk::kBFloat16) return dispatch_cout<__nv_bfloat16>(DLK_ARGS);
#undef DLK_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel for this input type and output width that one SM holds
// at `smem_bytes` of shared memory a block (-1 on an error): for the notes in
// PERF.md, not used on any path.
extern "C" int fused_inverted_residual_blocks_per_sm(int dtype, int cout, int smem_bytes) {
  if (dtype == dlk::kFloat32) return dispatch_occupancy<float>(cout, smem_bytes);
  if (dtype == dlk::kBFloat16) return dispatch_occupancy<__nv_bfloat16>(cout, smem_bytes);
  return -1;
}
