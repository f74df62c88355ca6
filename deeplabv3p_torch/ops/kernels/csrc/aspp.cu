// Multi-rate atrous depthwise 3x3 convolution with folded BN + ReLU.
//
// Replaces the Pallas TPU kernel deeplabv3p_tpu/ops/pallas/aspp.py:
// multirate_atrous_depthwise (body `_kernel`): the depthwise stage of the
// three ASPP separable branches (rates (6,12,18) at OS16), each
//   out[r] = relu(dwconv3x3(x, k[r], dilation=rates[r], SAME) * scale[r] + bias[r])
// from ONE pass over the input.
//
// Bound: bytes, not FLOPs. Per output element it does 9 multiply-adds per
// rate on an input it shares with every other rate; at the main-path shape
// (1,32,32,320) f32 that is 17.7 MFLOP against 1.3 MB read and 3.9 MB
// written (3.4 FLOP/byte), far below the H100's ~20 FLOP/byte ridge for
// f32 outside the tensor cores. The byte bound is then 1.6 us at 3.35 TB/s;
// at batch 1 the grid is a single wave of short threads, so the kernel's
// time is set by its 27 L1/L2 tap reads' latency and the launch, not by HBM
// (PERF.md has the times).
//
// Design: one thread per (n, h, w, c) NHWC element. A block holds 32
// consecutive channels of 8 pixels, so a warp reads 32 consecutive channels
// of each tap (a coalesced 128-byte line in f32). The thread loops over the
// R rates and 9 taps, reading x through L1/L2 (the whole feature map, 1.3 MB,
// stays in the 50 MB L2, so the 27 tap reads per element cost L2, not HBM,
// bandwidth), accumulates in f32, applies the folded BN scale/bias and ReLU,
// and writes each rate's output. Taps outside the map are the SAME zero
// padding and are skipped. Index arithmetic is 32-bit, one division chain
// per thread. The input is read from HBM once for all rates, as in the
// Pallas kernel; the TPU's 128-lane channel blocks and VMEM-resident rate
// loop have no counterpart here.

#include "common.cuh"

namespace dlk {

struct Rates {
  int r[4];
};

template <typename T>
__global__ void multirate_dw_kernel(const T* __restrict__ x,
                                    const float* __restrict__ w,      // (R,3,3,C)
                                    const float* __restrict__ scale,  // (R,C) or null
                                    const float* __restrict__ bias,   // (R,C) or null
                                    T* __restrict__ out,              // (R,N,H,W,C)
                                    int n, int h, int wd, int c,
                                    int num_rates, Rates rates, int fuse) {
  const int pixels = n * h * wd;
  const int p = blockIdx.x * kPixTile + threadIdx.y;
  const int ch = blockIdx.y * kChanTile + threadIdx.x;
  if (p >= pixels || ch >= c) return;
  const int col = p % wd;
  const int row = (p / wd) % h;
  const T* xb = x + (p - (row * wd + col)) * c + ch;  // this image, this channel
  for (int ri = 0; ri < num_rates; ++ri) {
    const int rate = rates.r[ri];
    const float* wr = w + ri * 9 * c + ch;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int y = row + (dy - 1) * rate;
      if (y < 0 || y >= h) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = col + (dx - 1) * rate;
        if (xx < 0 || xx >= wd) continue;
        acc += to_f32(xb[(y * wd + xx) * c]) * wr[(dy * 3 + dx) * c];
      }
    }
    if (fuse) {
      acc = fmaxf(acc * scale[ri * c + ch] + bias[ri * c + ch], 0.f);
    }
    out[(ri * pixels + p) * c + ch] = from_f32<T>(acc);
  }
}

}  // namespace dlk

// Launches on `stream` (of the current device) and returns
// cudaGetLastError() (0 on success).
// x/out are f32 (dtype 0) or bf16 (dtype 1); kernels, scale and bias f32.
extern "C" int multirate_atrous_depthwise(const void* x, const void* kernels,
                                          const void* scale, const void* bias,
                                          void* out, int dtype, int n, int h,
                                          int w, int c, int num_rates, int r0,
                                          int r1, int r2, int r3, int fuse,
                                          void* stream) {
  if (num_rates < 1 || num_rates > 4) return static_cast<int>(cudaErrorInvalidValue);
  const int pixels = n * h * w;
  if (pixels == 0 || c == 0) return 0;
  dlk::Rates rates = {{r0, r1, r2, r3}};
  const dim3 grid = dlk::grid_for(pixels, c);
  const dim3 block(dlk::kChanTile, dlk::kPixTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(kernels);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == dlk::kFloat32) {
    dlk::multirate_dw_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), k, sc, bi, static_cast<float*>(out), n, h, w,
        c, num_rates, rates, fuse);
  } else if (dtype == dlk::kBFloat16) {
    dlk::multirate_dw_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), k, sc, bi,
        static_cast<__nv_bfloat16*>(out), n, h, w, c, num_rates, rates, fuse);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
