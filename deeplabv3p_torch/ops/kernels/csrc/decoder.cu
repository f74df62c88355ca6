// Fused DeepLabV3+ decoder front-end:
//   out = relu(BN(depthwise3x3_SAME(concat([bilinear_up(x_enc), skip48]))))
// without materialising the upsampled map or the concat.
//
// Replaces the Pallas TPU kernel deeplabv3p_tpu/ops/pallas/decoder.py:
// fused_decoder_frontend (body `_kernel_impl`).
//
// Bound: bytes, not FLOPs. At the main-path shape, x_enc (1,32,32,256) +
// skip48 (1,128,128,48) -> (1,128,128,304) in bf16, the kernel reads 0.5 MB +
// 1.6 MB and writes the 10 MB output once: 3.6 us at 3.35 TB/s. The first
// version (one thread an output element, each re-sampling its 9 bilinear taps
// from L1/L2: 36 loads and 27 lerps) was bound by instruction issue at 107 us
// on an NVIDIA H100 80GB HBM3 at 700 W; this one takes 13.3-13.5 us of device
// time there (PERF.md has the table and what was tried).
//
// Design: separable, in shared memory, and the 3x3 stencil's vertical half
// moved to the encoder's width. With U the upsampled map, V its rows
// interpolated only vertically (output rows x ENCODER columns) and R_w the
// column interpolation,
//   out[y][x] = sum_dx sum_dy k[dy][dx] U[y+dy-1][x+dx-1]
//             = sum_dx (R_w W_dx[y])[x+dx-1],
//   W_dx[y][j] = sum_dy k[dy][dx] V[y+dy-1][j],
// because R_w is linear and does not depend on the row. W_dx lives at the
// encoder's width (`we` columns, 4x fewer than `ws` at the main path), so an
// output costs 3 lerps from shared memory and the 9-tap stencil is paid once
// an ENCODER column: where an output cost 36 global loads + 27 lerps + 9 FMAs
// it costs 2.25 shared loads + 6 FMAs + 2.25 FMAs' share.
// * An encoder block owns a tile of up to 4 output rows x the full width x a
//   group of 32 channels; threadIdx.x walks the group's channel vectors (4
//   consecutive channels a thread: 16-byte f32 and 8-byte bf16 loads and
//   stores, a warp's stores covering whole 32-byte sectors), threadIdx.y the
//   columns.
// * Tap geometry once a block: a table of (lo, hi, frac, valid) per output
//   column and per tile row with its halo, with the edge clamp of the JAX
//   `_resize_weights`, so any scale works. A halo row outside the map is zero
//   (the depthwise SAME padding of the UPSAMPLED map, Pallas's all-zero slab
//   rows); a tap column outside the map is skipped.
// * Phase 1: a thread owns an encoder column of its 4 channels, holds their 9
//   weights in registers and walks down the tile's rows + halo with a 3-row
//   window of V in registers (each encoder row is loaded once a run of rows
//   that reach it), writing W_0..2 to shared memory. Phase 2: a thread takes 4
//   consecutive output columns at a time, each output 3 lerps of W_dx at its
//   tap columns with the W_dx vectors shared along the run, then the folded
//   BN, ReLU, one rounding at the store. Accumulation is f32 throughout.
// * The skip channels (the last Cs) are further blocks of the same launch
//   (past the encoder blocks): a plain 3x3 depthwise from device memory with
//   the same channel vectors, one output pixel's vector a thread.
// * Channel counts that are no multiple of 4 (or unaligned pointers) take the
//   same kernel with one channel a thread (32 threads a pixel, still
//   coalesced); the wrapper chooses.
// Shared memory: 3 * tile * we * 32 floats + tables. At the main path: tile 4,
// 51,552 B a block (dynamic, above 48 KB), 80 registers a thread, 3 blocks an
// SM; 32 row tiles x 8 channel groups = 256 encoder blocks + 768 skip blocks
// for 132 SMs at batch 1. A wider encoder map halves the tile until the plan
// fits 227 KB (OS8's 64 columns: 100,704 B at tile 4).
// The TPU version's MXU interpolation matrices and 128-lane channel blocks
// (hence its Ce % 128 gate) have no counterpart.

#include "common.cuh"

namespace dlk {

constexpr int kDecGroup = 32;     // channels a block owns
constexpr int kDecThreads = 256;  // (kDecGroup / VEC) channel vectors x columns
constexpr int kDecMaxTile = 4;    // output rows a block owns, at most
constexpr int kDecRun = 4;        // consecutive output columns a thread takes at a time

// Source indices (clamped) and fraction of the half-pixel bilinear sample at
// output coordinate `o`, for an in/out size ratio `scale`; valid = inside the
// output map.
struct __align__(16) DecTap {
  int lo, hi;
  float frac;
  int valid;
};

//
// A row block of a larger map (spatial partitioning) passes its place in it:
// output row `o` is global row `o + o0` and the input holds global rows
// `i0_first ..` of `in_total`; the sample is taken in global coordinates and
// clamped at the global map's edges, then indexed into the block. A whole map
// has o0 = i0_first = 0 and in_total = in_size.
__device__ __forceinline__ DecTap decoder_tap(int o, float scale, int in_size, int out_size,
                                              int o0 = 0, int i0_first = 0,
                                              int in_total = 0) {
  const int total = in_total > 0 ? in_total : in_size;
  const float src = (o + o0 + 0.5f) * scale - 0.5f;
  const float fl = floorf(src);
  const int i0 = static_cast<int>(fl);
  DecTap t;
  t.lo = min(max(i0, 0), total - 1) - i0_first;
  t.hi = min(max(i0 + 1, 0), total - 1) - i0_first;
  t.frac = src - fl;
  t.valid = (o >= 0 && o < out_size) ? 1 : 0;
  return t;
}

// VEC (1 or 4) consecutive channels as one 2-, 4-, 8- or 16-byte access
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]);
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]);

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float (&out)[1]) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                           float (&out)[1]) {
  out[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(const __nv_bfloat16* p,
                                                           float (&out)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the high half of its f32
  out[0] = __uint_as_float(v.x << 16), out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16), out[3] = __uint_as_float(v.y & 0xffff0000u);
}
template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p, const float (&v)[1]) {
  *p = v[0];
}
template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(__nv_bfloat16* p,
                                                            const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 4>(__nv_bfloat16* p,
                                                            const float (&v)[4]) {
  // round to nearest even, two at a time (the low half is the first channel)
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned*>(&a);
  w.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

inline size_t decoder_smem_bytes(int we, int ws, int tile) {
  return (2 * kDecGroup + 3 * static_cast<size_t>(tile) * we * kDecGroup) * sizeof(float) +
         (static_cast<size_t>(ws) + tile + 2) * sizeof(DecTap);
}

// Output rows a block owns: the largest of 4, 2, 1 whose plan fits a block's
// shared memory, 0 if none does.
inline int decoder_tile_rows(int we, int ws) {
  for (int tile = kDecMaxTile; tile >= 1; tile /= 2)
    if (decoder_smem_bytes(we, ws, tile) <= kMaxSmem) return tile;
  return 0;
}

// The skip channels (the last Cs of the concat): a plain 3x3 depthwise, SAME,
// from device memory, one thread an output pixel's VEC channels (an item), its
// 9 taps' loads in flight together; L1 serves the nine-fold reuse. These
// blocks are bound by the latency of their loads (taking the loads away takes
// their time away, taking the stores away does not): runs of 4 or 8 columns a
// thread, with 3.75 loads an output, were no faster on the card.
template <typename T, int VEC>
__device__ __forceinline__ void decoder_skip_item(const T* __restrict__ skip,
                                                  const float* __restrict__ dwk,
                                                  const float* __restrict__ scale,
                                                  const float* __restrict__ bias,
                                                  T* __restrict__ out, int item, int ce, int hs,
                                                  int ws, int cs) {
  const int nvec = cs / VEC, ct = ce + cs;
  const int p = item / nvec, ch = (item - p * nvec) * VEC;  // pixel, first skip channel
  const int x = p % ws, y = (p / ws) % hs;
  float acc[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc[u] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = y + dy - 1;
    if (yy < 0 || yy >= hs) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x + dx - 1;
      if (xx < 0 || xx >= ws) continue;
      float v[VEC], k[VEC];
      load_vec<T, VEC>(skip + static_cast<size_t>(p + (dy - 1) * ws + dx - 1) * cs + ch, v);
      load_vec<float, VEC>(dwk + (dy * 3 + dx) * ct + ce + ch, k);
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[u] += v[u] * k[u];
    }
  }
  float s4[VEC], b4[VEC];
  load_vec<float, VEC>(scale + ce + ch, s4);
  load_vec<float, VEC>(bias + ce + ch, b4);
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc[u] = fmaxf(acc[u] * s4[u] + b4[u], 0.f);
  store_vec<T, VEC>(out + static_cast<size_t>(p) * ct + ce + ch, acc);
}

// Grid: enc_blocks = N * row tiles * channel groups blocks for the encoder
// channels (the first Ce of the concat; the group is the fastest index), then
// ceil(skip_items / kDecThreads) blocks for the skip channels. Block (kDecGroup
// / VEC, kDecThreads / (kDecGroup / VEC)), dynamic shared memory
// decoder_smem_bytes().
template <typename T, int VEC>
__global__ void __launch_bounds__(kDecThreads)
    decoder_frontend_kernel(const T* __restrict__ x_enc,    // (N,he,we,Ce)
                            const T* __restrict__ skip,     // (N,hs,ws,Cs)
                            const float* __restrict__ dwk,  // (3,3,Ce+Cs)
                            const float* __restrict__ scale, const float* __restrict__ bias,
                            T* __restrict__ out,            // (N,hs,ws,Ce+Cs)
                            int he, int we, int ce, int hs, int ws, int cs, float sh, float sw,
                            int tile, int enc_blocks, int skip_items, int row0, int erow0,
                            int he_total) {
  extern __shared__ __align__(16) float smem[];
  const int cv = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;
  const int tid = ty * blockDim.x + cv, nthreads = blockDim.x * ny;
  if (static_cast<int>(blockIdx.x) >= enc_blocks) {  // a block of skip channels
    const int item = (blockIdx.x - enc_blocks) * nthreads + tid;
    if (item < skip_items)
      decoder_skip_item<T, VEC>(skip, dwk, scale, bias, out, item, ce, hs, ws, cs);
    return;
  }
  const int ct = ce + cs;
  const int groups = (ce + kDecGroup - 1) / kDecGroup, tiles = (hs + tile - 1) / tile;
  const int group = blockIdx.x % groups, rt = blockIdx.x / groups;  // row tile of the batch
  const int b = rt / tiles;
  const int y0 = (rt - b * tiles) * tile;
  const int rows = min(tile, hs - y0);
  const int c0 = group * kDecGroup;  // the group's first channel
  const int nch = min(kDecGroup, ce - c0);
  const int nvec = nch / VEC;  // the wrapper takes VEC > 1 only where it divides Ce and Cs

  float* sc = smem;                 // the group's folded BN scale and bias
  float* bi = smem + kDecGroup;
  float* wbuf = smem + 2 * kDecGroup;  // W_dx: (3, tile, we, kDecGroup)
  for (int t = tid; t < nch; t += nthreads) {
    sc[t] = scale[c0 + t];
    bi[t] = bias[c0 + t];
  }
  T* ob = out + (static_cast<size_t>(b) * hs + y0) * ws * ct + c0;

  DecTap* coltab = reinterpret_cast<DecTap*>(wbuf + 3 * tile * we * kDecGroup);
  DecTap* rowtab = coltab + ws;  // rows y0 - 1 .. y0 + rows
  for (int x = tid; x < ws; x += nthreads) coltab[x] = decoder_tap(x, sw, we, ws);
  for (int r = tid; r < rows + 2; r += nthreads)
    rowtab[r] = decoder_tap(y0 - 1 + r, sh, he, hs, row0, erow0, he_total);
  __syncthreads();

  // Phase 1: W_dx[y][j] = sum_dy k[dy][dx] V[y + dy - 1][j]
  if (cv < nvec) {
    float k[9][VEC];
#pragma unroll
    for (int t = 0; t < 9; ++t) load_vec<float, VEC>(dwk + t * ct + c0 + cv * VEC, k[t]);
    for (int j = ty; j < we; j += ny) {
      const T* col = x_enc + (static_cast<size_t>(b) * he * we + j) * ce + c0 + cv * VEC;
      float v0[VEC], v1[VEC], v2[VEC], a[VEC], c[VEC];
      int ia = -1, ic = -1;  // the encoder rows held in a and c
#pragma unroll
      for (int u = 0; u < VEC; ++u) v0[u] = v1[u] = a[u] = c[u] = 0.f;
      for (int r = 0; r < rows + 2; ++r) {
        const DecTap t = rowtab[r];
        if (t.valid) {
          if (t.lo != ia) {
            if (t.lo == ic) {
#pragma unroll
              for (int u = 0; u < VEC; ++u) a[u] = c[u];
            } else {
              load_vec<T, VEC>(col + static_cast<size_t>(t.lo) * we * ce, a);
            }
            ia = t.lo;
          }
          if (t.hi != ic) {
            load_vec<T, VEC>(col + static_cast<size_t>(t.hi) * we * ce, c);
            ic = t.hi;
          }
#pragma unroll
          for (int u = 0; u < VEC; ++u) v2[u] = (1.f - t.frac) * a[u] + t.frac * c[u];
        } else {
#pragma unroll
          for (int u = 0; u < VEC; ++u) v2[u] = 0.f;
        }
        if (r >= 2) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float w[VEC];
#pragma unroll
            for (int u = 0; u < VEC; ++u)
              w[u] = k[dx][u] * v0[u] + k[3 + dx][u] * v1[u] + k[6 + dx][u] * v2[u];
            store_vec<float, VEC>(wbuf + ((dx * tile + r - 2) * we + j) * kDecGroup + cv * VEC,
                                  w);
          }
        }
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          v0[u] = v1[u];
          v1[u] = v2[u];
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: out[y][x] = relu(BN(sum_dx lerp_x(W_dx[y])[x + dx - 1])). A
  // thread takes a run of kDecRun consecutive columns at a time and walks the
  // kDecRun + 2 tap columns they reach; neighbouring columns mostly share
  // their two encoder columns, so each W_dx vector is loaded once a run (ilo
  // and ihi name what vlo and vhi hold): 9 loads for 4 outputs at scale 4
  // where column-at-a-time took 24.
  if (cv < nvec) {
    float s4[VEC], b4[VEC];
    load_vec<float, VEC>(sc + cv * VEC, s4);
    load_vec<float, VEC>(bi + cv * VEC, b4);
    for (int y = 0; y < rows; ++y) {
      for (int x0 = ty * kDecRun; x0 < ws; x0 += ny * kDecRun) {
        float acc[kDecRun][VEC], vlo[3][VEC], vhi[3][VEC];
        int ilo[3] = {-1, -1, -1}, ihi[3] = {-1, -1, -1};
#pragma unroll
        for (int u = 0; u < kDecRun; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
#pragma unroll
        for (int step = 0; step < kDecRun + 2; ++step) {
          const int xx = x0 - 1 + step;  // a tap column; outside the map it adds 0
          if (xx < 0 || xx >= ws) continue;
          const DecTap t = coltab[xx];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int u = step - dx;  // the output column x0 + u has xx as its tap dx
            if (u < 0 || u >= kDecRun) continue;
            const float* wrow = wbuf + (dx * tile + y) * we * kDecGroup + cv * VEC;
            if (t.lo != ilo[dx]) {
              if (t.lo == ihi[dx]) {
#pragma unroll
                for (int e = 0; e < VEC; ++e) vlo[dx][e] = vhi[dx][e];
              } else {
                load_vec<float, VEC>(wrow + t.lo * kDecGroup, vlo[dx]);
              }
              ilo[dx] = t.lo;
            }
            if (t.hi != ihi[dx]) {
              load_vec<float, VEC>(wrow + t.hi * kDecGroup, vhi[dx]);
              ihi[dx] = t.hi;
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[u][e] += (1.f - t.frac) * vlo[dx][e] + t.frac * vhi[dx][e];
          }
        }
#pragma unroll
        for (int u = 0; u < kDecRun; ++u) {
          if (x0 + u >= ws) break;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[u][e] = fmaxf(acc[u][e] * s4[e] + b4[e], 0.f);
          store_vec<T, VEC>(ob + (y * ws + x0 + u) * ct + cv * VEC, acc[u]);
        }
      }
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_decoder(const void* x_enc, const void* skip, const float* dwk,
                           const float* scale, const float* bias, void* out, int n, int he,
                           int we, int ce, int hs, int ws, int cs, float sh, float sw,
                           int row0, int erow0, int he_total, cudaStream_t stream) {
  const int tile = decoder_tile_rows(we, ws);
  if (tile == 0) return cudaErrorInvalidValue;
  const size_t smem = decoder_smem_bytes(we, ws, tile);
  cudaError_t err = allow_smem(decoder_frontend_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  const int enc_blocks = n * ((hs + tile - 1) / tile) * ((ce + kDecGroup - 1) / kDecGroup);
  const int skip_items = n * hs * ws * (cs / VEC);
  const int skip_blocks = (skip_items + kDecThreads - 1) / kDecThreads;
  const dim3 block(kDecGroup / VEC, kDecThreads / (kDecGroup / VEC));
  decoder_frontend_kernel<T, VEC><<<enc_blocks + skip_blocks, block, smem, stream>>>(
      static_cast<const T*>(x_enc), static_cast<const T*>(skip), dwk, scale, bias,
      static_cast<T*>(out), he, we, ce, hs, ws, cs, sh, sw, tile, enc_blocks, skip_items, row0,
      erow0, he_total);
  return cudaGetLastError();
}

}  // namespace dlk

// Output rows a block owns for an encoder map `we` wide and an output `ws`
// wide (0: no plan fits a block's shared memory), and that plan's bytes.
extern "C" int fused_decoder_frontend_tile_rows(int we, int ws) {
  return dlk::decoder_tile_rows(we, ws);
}

extern "C" long long fused_decoder_frontend_smem_bytes(int we, int ws) {
  const int tile = dlk::decoder_tile_rows(we, ws);
  return static_cast<long long>(dlk::decoder_smem_bytes(we, ws, tile == 0 ? 1 : tile));
}

// Launches on `stream` (of the current device) and returns a cudaError_t
// (0 on success). x_enc/skip/out are f32 (dtype 0) or bf16 (dtype 1);
// dw_kernel, scale and bias f32. sh = he / hs and sw = we / ws are the
// source-index scales (of the global map for a row block). vec is the
// channels a thread owns: 4 (Ce and Cs multiples of 4, every pointer 16-byte
// aligned) or 1. A row block of a map he_total x hs_total rows (spatial
// partitioning) passes the global rows of its first output row (row0) and of
// x_enc's first row (erow0); a whole map passes 0, 0, he.
extern "C" int fused_decoder_frontend(const void* x_enc, const void* skip,
                                      const void* dw_kernel, const void* scale,
                                      const void* bias, void* out, int dtype,
                                      int n, int he, int we, int ce, int hs,
                                      int ws, int cs, float sh, float sw, int vec,
                                      int row0, int erow0, int he_total, void* stream) {
  if (n * hs * ws == 0 || ce + cs == 0) return 0;
  if (vec == 4 && (ce % 4 != 0 || cs % 4 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(dw_kernel);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == dlk::kFloat32 && vec == 4) {
    err = dlk::launch_decoder<float, 4>(x_enc, skip, k, sc, bi, out, n, he, we, ce, hs, ws, cs,
                                        sh, sw, row0, erow0, he_total, s);
  } else if (dtype == dlk::kFloat32 && vec == 1) {
    err = dlk::launch_decoder<float, 1>(x_enc, skip, k, sc, bi, out, n, he, we, ce, hs, ws, cs,
                                        sh, sw, row0, erow0, he_total, s);
  } else if (dtype == dlk::kBFloat16 && vec == 4) {
    err = dlk::launch_decoder<__nv_bfloat16, 4>(x_enc, skip, k, sc, bi, out, n, he, we, ce, hs,
                                                ws, cs, sh, sw, row0, erow0, he_total, s);
  } else if (dtype == dlk::kBFloat16 && vec == 1) {
    err = dlk::launch_decoder<__nv_bfloat16, 1>(x_enc, skip, k, sc, bi, out, n, he, we, ce, hs,
                                                ws, cs, sh, sw, row0, erow0, he_total, s);
  }
  return static_cast<int>(err);
}
