// Fused DeepLabV3+ decoder front-end:
//   out = relu(BN(depthwise3x3_SAME(concat([bilinear_up(x_enc), skip48]))))
// without materialising the upsampled map or the concat.
//
// Replaces the Pallas TPU kernel deeplabv3p_tpu/ops/pallas/decoder.py:
// fused_decoder_frontend (body `_kernel_impl`).
//
// Bound: the operation is bound by bytes, not FLOPs: 9 multiply-adds per
// output element. At the main-path shape, x_enc (1,32,32,256) + skip48
// (1,128,128,48) -> (1,128,128,304) in bf16, the unfused chain writes and
// re-reads the 4x upsampled map (8.4 MB) and the concat (10 MB) in HBM.
// This kernel reads 0.5 MB + 1.6 MB and writes the 10 MB output once, 12 MB
// in all, about 4 us at 3.35 TB/s. It pays in instructions instead: each
// encoder-channel output re-samples 9 bilinear taps (36 loads from L1/L2,
// 27 lerps), so this first version is bound by instruction issue, well
// above its byte bound (PERF.md has the times). Sharing a pixel's tap
// geometry across its channels, and the interpolated rows across taps (a
// separable, shared-memory version), is the way down to the byte bound.
//
// Design: one thread per (n, y, x, c) element of the (hs, ws, Ce+Cs) NHWC
// output. A block holds 32 consecutive channels of 8 pixels, so a warp's
// loads of each tap hit 32 consecutive channels (coalesced). The thread
// first works out its 3x3 taps' geometry: for each tap row and column, the
// two source indices and the fraction of the half-pixel bilinear sample,
// with the edge clamp of the JAX `_resize_weights` (src = (y + 0.5) * in/out
// - 0.5, neighbours clamped to [0, in-1]). For c < Ce each of the 9 taps is
// then the bilinear sample of x_enc at the tap's position; the four x_enc
// reads per tap come from L1/L2 (x_enc is 0.5 MB). Taps outside
// [0,hs)x[0,ws) are 0: that is the depthwise SAME padding of the upsampled
// map, which the Pallas kernel encoded as all-zero halo rows of its
// interpolation slabs. For c >= Ce the taps read skip48 directly.
// Accumulation, the folded BN and the ReLU are f32; the store rounds to the
// input's type. Index arithmetic is 32-bit. The TPU version's MXU
// interpolation matrices and 128-lane channel blocks (hence its Ce % 128
// gate) have no counterpart.

#include "common.cuh"

namespace dlk {

// Source indices (clamped) and fraction of the half-pixel bilinear sample
// at output coordinate `o`, for an in/out size ratio `scale`.
struct Tap {
  int lo, hi;
  float frac;
};

__device__ __forceinline__ Tap bilinear_tap(int o, float scale, int in_size) {
  const float src = (o + 0.5f) * scale - 0.5f;
  const float fl = floorf(src);
  const int i0 = static_cast<int>(fl);
  return {min(max(i0, 0), in_size - 1), min(max(i0 + 1, 0), in_size - 1), src - fl};
}

template <typename T>
__global__ void decoder_frontend_kernel(const T* __restrict__ x_enc,   // (N,he,we,Ce)
                                        const T* __restrict__ skip,    // (N,hs,ws,Cs)
                                        const float* __restrict__ dwk, // (3,3,Ce+Cs)
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias,
                                        T* __restrict__ out,           // (N,hs,ws,Ce+Cs)
                                        int n, int he, int we, int ce, int hs,
                                        int ws, int cs, float sh, float sw) {
  const int ct = ce + cs;
  const int pixels = n * hs * ws;
  const int p = blockIdx.x * kPixTile + threadIdx.y;
  const int ch = blockIdx.y * kChanTile + threadIdx.x;
  if (p >= pixels || ch >= ct) return;
  const int col = p % ws;
  const int row = (p / ws) % hs;
  const int b = p / (hs * ws);
  float acc = 0.f;
  if (ch < ce) {
    Tap ty[3], tx[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ty[d] = bilinear_tap(row + d - 1, sh, he);
      tx[d] = bilinear_tap(col + d - 1, sw, we);
    }
    const T* xb = x_enc + b * he * we * ce + ch;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int y = row + dy - 1;
      if (y < 0 || y >= hs) continue;
      const T* r0 = xb + ty[dy].lo * we * ce;
      const T* r1 = xb + ty[dy].hi * we * ce;
      const float fy = ty[dy].frac;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = col + dx - 1;
        if (xx < 0 || xx >= ws) continue;
        const int c0 = tx[dx].lo * ce, c1 = tx[dx].hi * ce;
        const float fx = tx[dx].frac;
        const float top = (1.f - fx) * to_f32(r0[c0]) + fx * to_f32(r0[c1]);
        const float bot = (1.f - fx) * to_f32(r1[c0]) + fx * to_f32(r1[c1]);
        acc += ((1.f - fy) * top + fy * bot) * dwk[(dy * 3 + dx) * ct + ch];
      }
    }
  } else {
    const T* sb = skip + b * hs * ws * cs + (ch - ce);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int y = row + dy - 1;
      if (y < 0 || y >= hs) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = col + dx - 1;
        if (xx < 0 || xx >= ws) continue;
        acc += to_f32(sb[(y * ws + xx) * cs]) * dwk[(dy * 3 + dx) * ct + ch];
      }
    }
  }
  out[p * ct + ch] = from_f32<T>(fmaxf(acc * scale[ch] + bias[ch], 0.f));
}

}  // namespace dlk

// Launches on `stream` (of the current device) and returns
// cudaGetLastError() (0 on success).
// x_enc/skip/out are f32 (dtype 0) or bf16 (dtype 1); dw_kernel, scale
// and bias f32. sh = he / hs and sw = we / ws are the source-index scales.
extern "C" int fused_decoder_frontend(const void* x_enc, const void* skip,
                                      const void* dw_kernel, const void* scale,
                                      const void* bias, void* out, int dtype,
                                      int n, int he, int we, int ce, int hs,
                                      int ws, int cs, float sh, float sw,
                                      void* stream) {
  const int pixels = n * hs * ws;
  if (pixels == 0 || ce + cs == 0) return 0;
  const dim3 grid = dlk::grid_for(pixels, ce + cs);
  const dim3 block(dlk::kChanTile, dlk::kPixTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(dw_kernel);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == dlk::kFloat32) {
    dlk::decoder_frontend_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x_enc), static_cast<const float*>(skip), k, sc,
        bi, static_cast<float*>(out), n, he, we, ce, hs, ws, cs, sh, sw);
  } else if (dtype == dlk::kBFloat16) {
    dlk::decoder_frontend_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x_enc),
        static_cast<const __nv_bfloat16*>(skip), k, sc, bi,
        static_cast<__nv_bfloat16*>(out), n, he, we, ce, hs, ws, cs, sh, sw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
