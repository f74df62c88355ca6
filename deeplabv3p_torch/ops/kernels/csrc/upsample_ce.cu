// Fused bilinear upsample + weighted cross-entropy + argmax (the train
// step's loss tail), forward and backward.
//
// Replaces the Pallas TPU kernels of deeplabv3p_tpu/ops/pallas/upsample_ce.py:
// `_fwd_kernel` (the forward pallas_call of `fused_upsample_ce`) and
// `_bwd_kernel` (the pallas_call of its custom VJP `_fused_bwd`). With
// z = bilinear_upsample(logits) at full resolution (half-pixel centres, edge
// taps clamped, exactly `interp_matrix`):
//   forward:  loss = sum_px (logsumexp_k z - z[label]) * wpx,
//             preds = argmax_k z (lowest index on ties), lse = logsumexp_k z;
//   backward: d_lr[k] = R_h^T [(softmax_k(z) - 1[label = k]) * wpx] R_w,
// where wpx already folds validity, class and sample weights (0 at ignored
// and out-of-range labels). The (B, H, W, C) logits, their softmax and their
// gradient never reach device memory.
//
// Layout: logits (B, h, w, C) f32, i.e. the model's channels_last NCHW
// output permuted for free; labels/wpx/preds/lse (B, H, W). The Pallas
// kernels take class-major (B, C, h, w) only because Mosaic wants 2-D
// vectors; here a pixel's C classes are contiguous.
//
// Bound: instruction issue, not bytes. At the training slice
// (16, 128, 128, 21) -> 512 x 512 the forward reads 22 MB of logits (held
// in the 50 MB L2 across blocks) plus 32 MB of labels and weights and writes
// 32 MB (preds and lse): ~26 us at 3.35 TB/s. But it evaluates 88 M
// (pixel, class) pairs at ~30 instructions each (4 shared-memory loads,
// 3 FMAs, an expf, the online-max branch): ~90 us at the card's full issue
// rate; it takes 182 us on an H100 80GB HBM3 at 700 W (PERF.md). The
// backward evaluates each pair twice and adds the column reduction of
// phase 2: 783 us there. Interpolating
// each staged row pair once per block (2 loads and 1 FMA a class instead
// of 4 and 3) is the first lever (ROADMAP Queue B 1).
//
// Forward design: one block per full-resolution row (b, y). The block stages
// the two low-resolution rows its taps reach in shared memory (2 w C
// floats, 21.5 KB at the slice), then each thread walks pixels x of the
// row: an online logsumexp over the classes (running max, rescaled sum),
// a strict-greater argmax and the pick of the label's logit. The loss is
// reduced without float atomics, in a fixed order: each block sums its
// row (warp shuffles, then across warps) into one partial, and a second
// kernel of this file sums the B H partials in one block. JAX carries the
// sum across its sequential grid instead. The forward also writes the
// per-pixel lse (16 MB at the slice) so the backward needs one class pass
// a pixel instead of two (the Pallas backward recomputes it).
//
// Backward design: one block per low-resolution row (b, i); no atomics.
// Its block visits only the full-resolution rows y with R_h[y, i] != 0
// (2 s of them for an integer scale s), staging low-resolution rows
// i-1..i+1. For each such y: phase 1, each thread takes pixels x and writes
// coeff[x][k] = R_h[y, i] wpx (exp(z_k - lse) - 1[label = k]) into a shared
// (W x C) row; phase 2, each thread owns fixed (j, k) entries of a shared
// (w x C) accumulator and adds sum_x R_w[x, j] coeff[x][k] over the 3 s
// columns x whose taps can reach j. The block writes row i of d_lr once.
// Each full-resolution pixel is recomputed by the two blocks of its row
// taps. The sums run in a fixed order, so the result is deterministic.
// Shared memory: (4 w C + W C) floats + 4 W words, 94 KB at the slice.

#include <math_constants.h>

#include "common.cuh"

namespace dlk {

constexpr int kCeThreads = 256;

// interp_matrix (deeplabv3p_tpu/ops/pallas/upsample_ce.py:81-97): src in
// double, both taps clamped to [0, in - 1], weights (1 - frac, frac) in f32.
__device__ __forceinline__ void taps_of(int dst, int in, int out, int& i0, int& i1,
                                        float& w0, float& w1) {
  const double src = (dst + 0.5) * (static_cast<double>(in) / out) - 0.5;
  const double f = floor(src);
  const int i = static_cast<int>(f);
  i0 = min(max(i, 0), in - 1);
  i1 = min(max(i + 1, 0), in - 1);
  w1 = static_cast<float>(src - f);
  w0 = static_cast<float>(1.0 - (src - f));
}

// Column taps of every full-resolution x, shared by the block.
struct ColTaps {
  int* j0;
  int* j1;
  float* w0;
  float* w1;
};

__device__ __forceinline__ ColTaps col_taps(float* smem, int W) {
  ColTaps t;
  t.j0 = reinterpret_cast<int*>(smem);
  t.j1 = t.j0 + W;
  t.w0 = reinterpret_cast<float*>(t.j1 + W);
  t.w1 = t.w0 + W;
  return t;
}

__device__ __forceinline__ void fill_col_taps(ColTaps t, int w, int W) {
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    taps_of(x, w, W, t.j0[x], t.j1[x], t.w0[x], t.w1[x]);
  }
}

// Upsampled logit of class k at one pixel: rows first, then columns, as the
// two interpolation matmuls of the Pallas kernel.
__device__ __forceinline__ float upsampled(const float* r0, const float* r1, float wy0,
                                           float wy1, int off0, int off1, float wx0,
                                           float wx1, int k) {
  const float v0 = wy0 * r0[off0 + k] + wy1 * r1[off0 + k];
  const float v1 = wy0 * r0[off1 + k] + wy1 * r1[off1 + k];
  return wx0 * v0 + wx1 * v1;
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    const int warps = (blockDim.x + 31) >> 5;
    v = lane < warps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  }
  return v;
}

// grid (H, B), block kCeThreads, dynamic shared memory fwd_smem_bytes().
__global__ void __launch_bounds__(kCeThreads)
    upsample_ce_fwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                           const float* __restrict__ wpx, int* __restrict__ preds,
                           float* __restrict__ lse_out, float* __restrict__ partial, int h,
                           int w, int c, int H, int W) {
  extern __shared__ float smem[];
  const int y = blockIdx.x, b = blockIdx.y;
  const int row = w * c;
  float* r0 = smem;
  float* r1 = smem + row;
  const ColTaps ct = col_taps(smem + 2 * row, W);
  int i0, i1;
  float wy0, wy1;
  taps_of(y, h, H, i0, i1, wy0, wy1);
  const float* src0 = logits + (static_cast<size_t>(b) * h + i0) * row;
  const float* src1 = logits + (static_cast<size_t>(b) * h + i1) * row;
  for (int t = threadIdx.x; t < row; t += blockDim.x) {
    r0[t] = src0[t];
    r1[t] = src1[t];
  }
  fill_col_taps(ct, w, W);
  __syncthreads();

  const size_t base = (static_cast<size_t>(b) * H + y) * W;
  float acc = 0.f;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int off0 = ct.j0[x] * c, off1 = ct.j1[x] * c;
    const float wx0 = ct.w0[x], wx1 = ct.w1[x];
    const int label = labels[base + x];
    float m = -CUDART_INF_F, s = 0.f, zl = 0.f;
    int best = 0;
    for (int k = 0; k < c; ++k) {
      const float z = upsampled(r0, r1, wy0, wy1, off0, off1, wx0, wx1, k);
      if (z > m) {  // strict: ties keep the lower class index
        s = s * expf(m - z) + 1.f;
        m = z;
        best = k;
      } else {
        s += expf(z - m);
      }
      if (k == label) zl = z;
    }
    const float lse = logf(s) + m;
    preds[base + x] = best;
    lse_out[base + x] = lse;
    acc += (lse - zl) * wpx[base + x];  // wpx is 0 at invalid labels
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[static_cast<size_t>(b) * H + y] = acc;
}

// One block: out[0] = sum of the n partials, in a fixed order.
__global__ void __launch_bounds__(kCeThreads)
    sum_partials_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
  float v = 0.f;
  for (int t = threadIdx.x; t < n; t += blockDim.x) v += partial[t];
  v = block_sum(v);
  if (threadIdx.x == 0) out[0] = v;
}

// grid (h, B), block kCeThreads, dynamic shared memory bwd_smem_bytes().
__global__ void __launch_bounds__(kCeThreads)
    upsample_ce_bwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                           const float* __restrict__ wpx, const float* __restrict__ lse,
                           float* __restrict__ dlr, int h, int w, int c, int H, int W) {
  extern __shared__ float smem[];
  const int i = blockIdx.x, b = blockIdx.y;
  const int row = w * c;
  float* rows = smem;               // low-resolution rows i-1, i, i+1
  float* coeff = rows + 3 * row;    // (W, C) of the current full-resolution row
  float* acc = coeff + W * c;       // (w, C): row i of d_lr
  const ColTaps ct = col_taps(acc + row, W);
  const int lo = max(i - 1, 0), hi = min(i + 1, h - 1);
  for (int r = lo; r <= hi; ++r) {
    const float* src = logits + (static_cast<size_t>(b) * h + r) * row;
    float* dst = rows + (r - i + 1) * row;
    for (int t = threadIdx.x; t < row; t += blockDim.x) dst[t] = src[t];
  }
  for (int t = threadIdx.x; t < row; t += blockDim.x) acc[t] = 0.f;
  fill_col_taps(ct, w, W);
  __syncthreads();

  // Integer scales (the wrapper checks): the taps of y are
  // floor((y + 0.5) / s - 0.5) and the next one, so only y in
  // [(i - 1) s, (i + 2) s) can reach row i; likewise x for column j.
  const int sh = H / h, sw = W / w;
  const int y_end = min((i + 2) * sh, H);
  for (int y = max((i - 1) * sh, 0); y < y_end; ++y) {
    int i0, i1;
    float wy0, wy1;
    taps_of(y, h, H, i0, i1, wy0, wy1);
    const float wy = (i0 == i ? wy0 : 0.f) + (i1 == i ? wy1 : 0.f);
    if (wy == 0.f) continue;  // the same for the whole block
    const float* r0 = rows + (i0 - i + 1) * row;
    const float* r1 = rows + (i1 - i + 1) * row;
    const size_t base = (static_cast<size_t>(b) * H + y) * W;
    // phase 1: coeff[x][k] = R_h[y, i] wpx (softmax_k - 1[label = k])
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const int off0 = ct.j0[x] * c, off1 = ct.j1[x] * c;
      const float wx0 = ct.w0[x], wx1 = ct.w1[x];
      const int label = labels[base + x];
      const float l = lse[base + x];
      const float g = wy * wpx[base + x];
      float* cx = coeff + x * c;
      for (int k = 0; k < c; ++k) {
        const float z = upsampled(r0, r1, wy0, wy1, off0, off1, wx0, wx1, k);
        cx[k] = g * (expf(z - l) - (k == label ? 1.f : 0.f));
      }
    }
    __syncthreads();
    // phase 2: acc[j][k] += sum_x R_w[x, j] coeff[x][k]; each (j, k) has
    // one owner thread, so no atomics and a fixed order
    for (int p = threadIdx.x; p < row; p += blockDim.x) {
      const int j = p / c, k = p - j * c;
      const int x_end = min((j + 2) * sw, W);
      float sum = 0.f;
      for (int x = max((j - 1) * sw, 0); x < x_end; ++x) {
        const float wx = (ct.j0[x] == j ? ct.w0[x] : 0.f) + (ct.j1[x] == j ? ct.w1[x] : 0.f);
        sum += wx * coeff[x * c + k];
      }
      acc[p] += sum;
    }
    __syncthreads();
  }
  float* out = dlr + (static_cast<size_t>(b) * h + i) * row;
  for (int t = threadIdx.x; t < row; t += blockDim.x) out[t] = acc[t];
}

inline size_t fwd_smem_bytes(int w, int c, int W) {
  return (2 * static_cast<size_t>(w) * c + 4 * static_cast<size_t>(W)) * sizeof(float);
}

inline size_t bwd_smem_bytes(int w, int c, int W) {
  return (4 * static_cast<size_t>(w) * c + static_cast<size_t>(W) * c +
          4 * static_cast<size_t>(W)) * sizeof(float);
}

constexpr size_t kMaxSmem = 232448;  // 227 KB a block on sm_90

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline bool bad_shape(int b, int h, int w, int c, int H, int W) {
  return b < 1 || h < 1 || w < 1 || c < 1 || H % h != 0 || W % w != 0 || b > 65535;
}

}  // namespace dlk

// Both launch on `stream` (of the current device) and return a cudaError_t
// (0 on success). `partial` is scratch of b * H floats; `loss` one float.
extern "C" int upsample_ce_forward(const void* logits, const void* labels, const void* wpx,
                                   void* preds, void* lse, void* partial, void* loss, int b,
                                   int h, int w, int c, int H, int W, void* stream) {
  if (dlk::bad_shape(b, h, w, c, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dlk::fwd_smem_bytes(w, c, W);
  cudaError_t err = dlk::allow_smem(dlk::upsample_ce_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dlk::upsample_ce_fwd_kernel<<<dim3(H, b), dlk::kCeThreads, smem, s>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(wpx), static_cast<int*>(preds), static_cast<float*>(lse),
      static_cast<float*>(partial), h, w, c, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dlk::sum_partials_kernel<<<1, dlk::kCeThreads, 0, s>>>(static_cast<const float*>(partial),
                                                          b * H, static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int upsample_ce_backward(const void* logits, const void* labels, const void* wpx,
                                    const void* lse, void* dlr, int b, int h, int w, int c,
                                    int H, int W, void* stream) {
  if (dlk::bad_shape(b, h, w, c, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dlk::bwd_smem_bytes(w, c, W);
  cudaError_t err = dlk::allow_smem(dlk::upsample_ce_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dlk::upsample_ce_bwd_kernel<<<dim3(h, b), dlk::kCeThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(wpx), static_cast<const float*>(lse),
      static_cast<float*>(dlr), h, w, c, H, W);
  return static_cast<int>(cudaGetLastError());
}
