// Stride-1 MobileNetV2 inverted residual in one pass (inference).
//
// Replaces the Pallas TPU kernel deeplabv3p_tpu/ops/pallas/mbconv.py:
// fused_inverted_residual (body `_kernel`):
//   e = bf16(relu6((x @ we) * se + be))                      expand 1x1 + BN
//   d = bf16(relu6(dw3x3(e, wd, dilation=rate, SAME) * sd + bd))
//   y = (d @ wp) * sp + bp  (+ x)                            project 1x1 + BN
// with the 6x-expanded tensors e and d never in device memory. Both 1x1
// products are computed here, in the kernel's body, as the Pallas kernel
// computes them in its own: plain f32 FMAs, no library call.
//
// Bound: operations. At the eval path's 13 block shapes (batch 8, 512x512,
// OS16) a block reads x and writes y once, 2.3-12.6 MB, against 0.86-7.7
// GFLOP: 170-790 FLOP a byte, far above the card's f32 ridge (67 TFLOP/s /
// 3.35 TB/s = 20). The products are f32 x f32 (the weights are f32, as in
// the Pallas kernel), so the bound is the work over the f32 FMA rate: 12.9 us
// (blocks 7-9) to 114.8 us (block 16), 477 us for all 13 (PERF.md has the
// measured times). The tensor cores (`wgmma`, with weights rounded to bf16 or
// TF32) are the later lever.
//
// Design. One block of 256 threads (8 warps x 32 lanes) owns an 8x8 output
// tile of one image. What the TPU version does for the TPU's sake is
// dropped: the input passed three times with clamped index maps, the padding
// of Cexp to 128 lanes, the 8 MB VMEM tile rule.
// * the input tile with its `rate` halo, (8+2r)^2 pixels x Cin, is staged
//   once in shared memory in x's type (zeros outside the image);
// * Cexp is walked in chunks of 32 channels, lane = channel (a last partial
//   chunk just idles lanes, so Cexp = 144 needs no padding). For a chunk:
//   - expand: a warp takes 8 halo pixels at a time; a lane holds its
//     channel's 8 sums, reads 4 input channels of a pixel with one
//     (broadcast) shared load, and rounds relu6(BN(.)) to bf16 into a
//     shared (halo pixels x 32) tile. Halo pixels outside the image are
//     ZERO there, in E-space, after BN + relu6: that is the depthwise
//     conv's SAME padding (a zero input row would give relu6(be) != 0);
//   - depthwise: warp w owns tile column w, a lane the 8 pixels of that
//     column for its channel: 9 taps from the shared e tile, BN + relu6,
//     rounded to bf16 into a shared (64 x 32) tile;
//   - project: the same thread owns output pixels (row 0..7, column w) x
//     output channels (lane + 32 j): up to 8 x 10 f32 accumulators in
//     registers across all chunks, d read as broadcasts of 4 channels,
//     wp read coalesced through L1;
// * epilogue: project BN fold, residual add from the staged input tile,
//   all in f32, one rounding to x's type, coalesced store.
// BN folds and the residual add are f32; e and d round to bf16 exactly where
// the Pallas kernel rounds them, whatever x's type.

#include "common.cuh"

namespace dlk {

constexpr int kTile = 8;          // output tile side, and warps a block
constexpr int kChunk = 32;        // expanded channels a pass: one a lane
constexpr int kExpandPixels = 8;  // halo pixels a warp expands at a time
constexpr int kMbconvThreads = kChunk * kTile;
constexpr int kMbconvMaxSmem = 232448;  // 227 KB a block on sm_90

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// four bf16 in one 8-byte load; bf16 -> f32 is a 16-bit shift
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store4_zero(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void store4_zero(__nv_bfloat16* p) {
  *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// shared-memory layout, shared with the host's size computation
__host__ __device__ inline size_t mbconv_x_bytes(int halo_pixels, int cin, size_t elem) {
  return (static_cast<size_t>(halo_pixels) * cin * elem + 15) / 16 * 16;
}
__host__ __device__ inline size_t mbconv_smem_bytes(int rate, int cin, size_t elem) {
  const int side = kTile + 2 * rate;
  const int hp = side * side;
  return mbconv_x_bytes(hp, cin, elem) +
         sizeof(__nv_bfloat16) * kChunk * (static_cast<size_t>(hp) + kTile * kTile);
}

template <typename T, int CJ>
__global__ void __launch_bounds__(kMbconvThreads)
mbconv_kernel(const T* __restrict__ x,        // (N,H,W,Cin)
              const float* __restrict__ we,   // (Cin,Cexp)
              const float* __restrict__ se, const float* __restrict__ be,
              const float* __restrict__ wd,   // (3,3,Cexp)
              const float* __restrict__ sd, const float* __restrict__ bd,
              const float* __restrict__ wp,   // (Cexp,Cout)
              const float* __restrict__ sp, const float* __restrict__ bp,
              T* __restrict__ out,            // (N,H,W,Cout)
              int h, int w, int cin, int cexp, int cout, int rate, int residual) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tx = threadIdx.x;  // lane: expanded channel of the chunk / output channel mod 32
  const int ty = threadIdx.y;  // warp: tile column
  const int side = kTile + 2 * rate;
  const int hp = side * side;
  T* xs = reinterpret_cast<T*>(smem_raw);
  __nv_bfloat16* es =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + mbconv_x_bytes(hp, cin, sizeof(T)));
  __nv_bfloat16* ds = es + hp * kChunk;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w;

  // stage the input tile and its halo, 4 channels a thread a step
  {
    const int vec_per_pixel = cin / 4;
    const int vecs = hp * vec_per_pixel;
    for (int v = ty * kChunk + tx; v < vecs; v += kMbconvThreads) {
      const int p = v / vec_per_pixel;
      const int k = (v - p * vec_per_pixel) * 4;
      const int hy = p / side, hx = p - hy * side;
      const int gy = y0 - rate + hy, gx = x0 - rate + hx;
      T* dst = xs + p * cin + k;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        copy4(dst, x + (image + static_cast<size_t>(gy) * w + gx) * cin + k);
      } else {
        store4_zero(dst);
      }
    }
  }
  __syncthreads();

  float acc[kTile][CJ];
#pragma unroll
  for (int pj = 0; pj < kTile; ++pj)
#pragma unroll
    for (int cj = 0; cj < CJ; ++cj) acc[pj][cj] = 0.f;

  for (int c0 = 0; c0 < cexp; c0 += kChunk) {
    const int ce = c0 + tx;
    const bool live = ce < cexp;

    // -- expand 1x1 + BN + relu6 over the halo tile --------------------------
    {
      const float s = live ? se[ce] : 0.f, b = live ? be[ce] : 0.f;
      for (int pg = ty * kExpandPixels; pg < hp; pg += kTile * kExpandPixels) {
        float a[kExpandPixels];
#pragma unroll
        for (int j = 0; j < kExpandPixels; ++j) a[j] = 0.f;
        for (int k = 0; k < cin; k += 4) {
          float wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = live ? we[(k + i) * cexp + ce] : 0.f;
#pragma unroll
          for (int j = 0; j < kExpandPixels; ++j) {
            const int p = min(pg + j, hp - 1);
            float xv[4];
            load4(xs + p * cin + k, xv);
#pragma unroll
            for (int i = 0; i < 4; ++i) a[j] = fmaf(xv[i], wv[i], a[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kExpandPixels; ++j) {
          const int p = pg + j;
          if (p < hp) {
            const int hy = p / side, hx = p - hy * side;
            const int gy = y0 - rate + hy, gx = x0 - rate + hx;
            const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
            // outside the image e is zero: the depthwise conv's SAME padding
            const float v = (inside && live) ? relu6f(a[j] * s + b) : 0.f;
            es[p * kChunk + tx] = __float2bfloat16(v);
          }
        }
      }
    }
    __syncthreads();

    // -- 3x3 depthwise (dilation `rate`) + BN + relu6 over the 8x8 tile -------
    {
      float wt[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wt[t] = live ? wd[t * cexp + ce] : 0.f;
      const float s = live ? sd[ce] : 0.f, b = live ? bd[ce] : 0.f;
#pragma unroll
      for (int pj = 0; pj < kTile; ++pj) {
        float a = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int p = (pj + dy * rate) * side + ty + dx * rate;
            a = fmaf(__bfloat162float(es[p * kChunk + tx]), wt[dy * 3 + dx], a);
          }
        // a dead lane's d is zero, so the projection below may run the whole chunk
        ds[(pj * kTile + ty) * kChunk + tx] = __float2bfloat16(live ? relu6f(a * s + b) : 0.f);
      }
    }
    __syncthreads();

    // -- project 1x1, accumulated over the chunks ----------------------------
    {
      const int kend = min(kChunk, (cexp - c0 + 3) / 4 * 4);
      for (int k = 0; k < kend; k += 4) {
        float dv[kTile][4];
#pragma unroll
        for (int pj = 0; pj < kTile; ++pj) load4(ds + (pj * kTile + ty) * kChunk + k, dv[pj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool row = c0 + k + i < cexp;
#pragma unroll
          for (int cj = 0; cj < CJ; ++cj) {
            const int co = tx + 32 * cj;
            const float wv = (row && co < cout) ? wp[(c0 + k + i) * cout + co] : 0.f;
#pragma unroll
            for (int pj = 0; pj < kTile; ++pj) acc[pj][cj] = fmaf(dv[pj][i], wv, acc[pj][cj]);
          }
        }
      }
    }
    // no barrier here: the next chunk's expand writes only `es`, which every
    // warp finished reading before the barrier above; `ds` is rewritten after
    // the next chunk's first barrier, when every warp has left this loop
  }

  // -- epilogue: project BN (+ residual) in f32, one rounding ------------------
  const int gx = x0 + ty;
  if (gx < w) {
#pragma unroll
    for (int cj = 0; cj < CJ; ++cj) {
      const int co = tx + 32 * cj;
      if (co < cout) {
        const float s = sp[co], b = bp[co];
#pragma unroll
        for (int pj = 0; pj < kTile; ++pj) {
          const int gy = y0 + pj;
          if (gy < h) {
            float y = acc[pj][cj] * s + b;
            if (residual) y += to_f32(xs[((pj + rate) * side + ty + rate) * cin + co]);
            out[(image + static_cast<size_t>(gy) * w + gx) * cout + co] = from_f32<T>(y);
          }
        }
      }
    }
  }
}

template <typename T, int CJ>
int launch_mbconv(const void* x, const float* we, const float* se, const float* be,
                  const float* wd, const float* sd, const float* bd, const float* wp,
                  const float* sp, const float* bp, void* out, int n, int h, int w, int cin,
                  int cexp, int cout, int rate, int residual, cudaStream_t s) {
  auto kernel = mbconv_kernel<T, CJ>;
  const size_t smem = mbconv_smem_bytes(rate, cin, sizeof(T));
  if (smem > kMbconvMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  const dim3 block(kChunk, kTile);
  kernel<<<grid, block, smem, s>>>(static_cast<const T*>(x), we, se, be, wd, sd, bd, wp, sp, bp,
                                   static_cast<T*>(out), h, w, cin, cexp, cout, rate, residual);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_cout(const void* x, const float* we, const float* se, const float* be,
                  const float* wd, const float* sd, const float* bd, const float* wp,
                  const float* sp, const float* bp, void* out, int n, int h, int w, int cin,
                  int cexp, int cout, int rate, int residual, cudaStream_t s) {
  // output channels a lane owns: the MobileNetV2 widths 24/32, 64, 96, 160, 320
  const int cj = (cout + 31) / 32;
#define DLK_MBCONV(CJ)                                                                     \
  return launch_mbconv<T, CJ>(x, we, se, be, wd, sd, bd, wp, sp, bp, out, n, h, w, cin, cexp, \
                              cout, rate, residual, s)
  if (cj <= 1) DLK_MBCONV(1);
  if (cj <= 2) DLK_MBCONV(2);
  if (cj <= 3) DLK_MBCONV(3);
  if (cj <= 5) DLK_MBCONV(5);
  if (cj <= 10) DLK_MBCONV(10);
#undef DLK_MBCONV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dlk

// Shared memory a block needs, in bytes, for the wrapper's check against the
// card's 227 KB (elem: bytes of one x element).
extern "C" long long fused_inverted_residual_smem_bytes(int rate, int cin, int elem) {
  return static_cast<long long>(dlk::mbconv_smem_bytes(rate, cin, static_cast<size_t>(elem)));
}

// x/out are f32 (dtype 0) or bf16 (dtype 1), NHWC; every other tensor f32.
// Needs cin % 4 == 0 (16-byte staging), cout <= 320, 1 <= rate, n <= 65535.
// Launches on `stream` (of the current device) and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_inverted_residual(const void* x, const void* we, const void* se,
                                       const void* be, const void* wd, const void* sd,
                                       const void* bd, const void* wp, const void* sp,
                                       const void* bp, void* out, int dtype, int n, int h, int w,
                                       int cin, int cexp, int cout, int rate, int residual,
                                       void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  if (cin <= 0 || cin % 4 != 0 || cexp <= 0 || cout <= 0 || rate < 1 || n > 65535 ||
      (h + dlk::kTile - 1) / dlk::kTile > 65535 || (residual && cin != cout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fwe = static_cast<const float*>(we);
  const float* fse = static_cast<const float*>(se);
  const float* fbe = static_cast<const float*>(be);
  const float* fwd = static_cast<const float*>(wd);
  const float* fsd = static_cast<const float*>(sd);
  const float* fbd = static_cast<const float*>(bd);
  const float* fwp = static_cast<const float*>(wp);
  const float* fsp = static_cast<const float*>(sp);
  const float* fbp = static_cast<const float*>(bp);
  if (dtype == dlk::kFloat32)
    return dlk::dispatch_cout<float>(x, fwe, fse, fbe, fwd, fsd, fbd, fwp, fsp, fbp, out, n, h,
                                     w, cin, cexp, cout, rate, residual, s);
  if (dtype == dlk::kBFloat16)
    return dlk::dispatch_cout<__nv_bfloat16>(x, fwe, fse, fbe, fwd, fsd, fbd, fwp, fsp, fbp, out,
                                             n, h, w, cin, cexp, cout, rate, residual, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
