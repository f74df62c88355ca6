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
// Bound: bytes by the roofline (forward 26.6 us, backward 28.2 us at the
// training slice (16, 128, 128, 21) -> 512 x 512: 22 MB of logits held in the
// 50 MB L2 across blocks, 32-48 MB of labels, weights and lse, 16-32 MB
// written), but both kernels are limited by instruction throughput and
// shared-memory loads: they evaluate 88 M (forward) and 2 x 88 M (backward)
// (pixel, class) pairs. On an NVIDIA H100 80GB HBM3 at 700 W the forward takes
// 187-189 us and the backward 255 us (786-798 us before its redesign;
// PERF.md has the table).
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
// a pixel instead of two (the Pallas backward recomputes it). Interpolating
// each staged row pair once (as the backward does) is its next lever.
//
// Backward design: one block of 512 threads per low-resolution row (b, i);
// no atomics. The gradient is linear in the full-resolution rows, so the
// block reduces over y first and over x once:
// * It visits only the rows y with R_h[y, i] != 0 (2 s of them for an integer
//   scale s), staging low-resolution rows i-1..i+1. A warp owns a run of
//   W / 16 pixels of every row and a lane every 32nd of them. For each y the
//   warp interpolates the staged row pair ONCE, for the few columns its
//   pixels reach, into its own buffer (v = (wy0 r0 + wy1 r1) log2 e, 16-byte
//   loads and stores, __syncwarp only), so a (pixel, class) costs two
//   16-byte-vectorised loads, two FMAs and one exp2 where it cost four loads
//   and three FMAs. The lane then adds R_h[y, i] wpx softmax_k into ITS OWN
//   slots of a shared (C, W) accumulator, eight classes at a time with every
//   load before the first store, and subtracts the one-hot term once a pixel.
//   No block barrier between rows; a pixel with zero weight is skipped.
// * Phase 2 runs once a block (it ran once a row): each (j, k) of row i has
//   one owner thread, which sums R_w[x, j] acc[k][x] over the 2 s columns
//   that reach j. For an interior column the weights depend on x - j s alone
//   and come from a 2 s table; the two edge columns take their clamped taps
//   exactly as taps_of gives them. Two barriers a block, a fixed order of
//   summation everywhere: two calls give the same bits.
// * Each full-resolution row is still evaluated by the two blocks whose rows
//   its taps reach. A block that owns two low-resolution rows (1.5x repeated
//   pixels instead of 2x) needs 150 KB of shared memory, one block an SM,
//   and was slower on the card (632 against 398 us at the same stage of the
//   work), so one row a block stayed.
// * labels, lse and wpx are read 4 bytes a lane, 32 consecutive pixels a warp:
//   whole 128-byte requests already, and the accumulator's layout wants
//   consecutive lanes on consecutive pixels, so 16-byte loads a lane were not
//   taken.
// Shared memory: 3 w C' + 16 (W / (16 s) + 3) C' + C (W + 1) + 3 W + 2 s
// floats with C' = C padded to 28 at C = 21: 112 KB at the slice, two blocks
// an SM.

#include <math_constants.h>

#include "common.cuh"

namespace dlk {

constexpr int kCeThreads = 256;
constexpr int kBwdThreads = 512;  // the backward's block: 16 warps
constexpr int kBwdBatch = 8;  // classes a lane evaluates before it touches its accumulators

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

// The backward's shared-memory plan, in floats, for the kernel and the host.
struct BwdPlan {
  int pitch;      // x pitch of the (C, pitch) accumulator: odd, so that both the
                  // lanes of one class and the classes of one column spread over banks
  int cs;         // floats between two columns' classes in the staged and interpolated
                  // rows: C padded to whole batches of 8 classes (16-byte loads), then
                  // to an odd number of 16-byte units (8 neighbouring columns then
                  // cover all 32 banks)
  int warp_px;    // pixels of a row a warp owns
  int vcols;      // low-resolution columns a warp's pixels can reach (upper bound)
  size_t floats;  // all of it
};

__host__ __device__ inline BwdPlan bwd_plan(int w, int c, int W, int warps) {
  BwdPlan p;
  p.pitch = W | 1;
  p.cs = (c + kBwdBatch - 1) / kBwdBatch * kBwdBatch;
  if ((p.cs / 4) % 2 == 0) p.cs += 4;
  p.warp_px = (W + warps - 1) / warps;
  const int sw = W / w;
  p.vcols = (p.warp_px + sw - 1) / sw + 3;
  p.floats = 3 * static_cast<size_t>(w) * p.cs +           // staged logits rows i-1, i, i+1
             static_cast<size_t>(warps) * p.vcols * p.cs + // row-interpolated logits, a warp each
             static_cast<size_t>(c) * p.pitch +            // accumulator
             2 * static_cast<size_t>(sw) +                 // interior column weights
             3 * static_cast<size_t>(W);                   // column taps
  return p;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// exp(z_k - lse) for 8 classes of one pixel, from the two columns' interpolated
// rows (already times log2 e) and lse log2 e
__device__ __forceinline__ void softmax8(const float* v0, const float* v1, float wx0, float wx1,
                                         float l2, float (&e)[kBwdBatch]) {
  const float4 p0 = *reinterpret_cast<const float4*>(v0);
  const float4 p1 = *reinterpret_cast<const float4*>(v0 + 4);
  const float4 q0 = *reinterpret_cast<const float4*>(v1);
  const float4 q1 = *reinterpret_cast<const float4*>(v1 + 4);
  const float p[kBwdBatch] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
  const float q[kBwdBatch] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int u = 0; u < kBwdBatch; ++u) e[u] = exp2_approx(fmaf(wx0, p[u], wx1 * q[u]) - l2);
}

// grid (h, B), block kBwdThreads, dynamic shared memory bwd_plan().
// The block owns low-resolution row i of d_lr.
__global__ void __launch_bounds__(kBwdThreads)
    upsample_ce_bwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                           const float* __restrict__ wpx, const float* __restrict__ lse,
                           float* __restrict__ dlr, int h, int w, int c, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int i = blockIdx.x, b = blockIdx.y;
  const int sh = H / h, sw = W / w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const BwdPlan plan = bwd_plan(w, c, W, warps);
  const int pitch = plan.pitch, cs = plan.cs;
  const int srow = w * cs;               // one staged row
  float* rows = smem;                    // low-resolution rows i-1, i, i+1, classes padded to cs
  float* vbuf = rows + 3 * srow + warp * plan.vcols * cs;  // this warp's interpolated rows
  float* acc = rows + 3 * srow + warps * plan.vcols * cs;  // (C, pitch): sum_y R_h[y, i] coeff[y]
  float* wtab = acc + c * pitch;
  // column taps of every x: j0 | j1 << 16, then the two weights
  int* tj = reinterpret_cast<int*>(wtab + 2 * sw);
  float* tw0 = reinterpret_cast<float*>(tj + W);
  float* tw1 = tw0 + W;

  for (int r = max(i - 1, 0); r <= min(i + 1, h - 1); ++r) {
    const float* src = logits + (static_cast<size_t>(b) * h + r) * w * c;
    float* dst = rows + (r - i + 1) * srow;
    for (int t = threadIdx.x; t < srow; t += blockDim.x) {
      const int j = t / cs, k = t - j * cs;
      dst[t] = k < c ? src[j * c + k] : 0.f;
    }
  }
  for (int t = threadIdx.x; t < c * pitch; t += blockDim.x) acc[t] = 0.f;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    int j0, j1;
    taps_of(x, w, W, j0, j1, tw0[x], tw1[x]);
    tj[x] = j0 | (j1 << 16);
  }
  // R_w[x, j] of an interior column j (no clamped tap) depends on x - j sw
  // alone: the 2 sw columns x with (x + 0.5) in [(j - 0.5) sw, (j + 1.5) sw),
  // tabulated at j = 1
  if (w >= 3) {
    for (int d = threadIdx.x; d < 2 * sw; d += blockDim.x) {
      int j0, j1;
      float w0, w1;
      taps_of(sw / 2 + d, w, W, j0, j1, w0, w1);
      wtab[d] = (j0 == 1 ? w0 : 0.f) + (j1 == 1 ? w1 : 0.f);
    }
  }
  __syncthreads();

  // Phase 1, no block barrier inside: a warp owns pixels [xa, xb) of every
  // row, a lane every 32nd of them, and adds its pixels' coefficients into
  // its own accumulator slots over all the rows y that reach row i.
  const int xa = warp * plan.warp_px, xb = min(xa + plan.warp_px, W);
  if (xa < xb) {
    const int jlo = tj[xa] & 0xffff;
    const int ncell4 = ((tj[xb - 1] >> 16) - jlo + 1) * cs / 4;
    // integer scales (the wrapper checks): only y in [(i - 1) sh, (i + 2) sh)
    // can reach row i
    const int y_end = min((i + 2) * sh, H);
    for (int y = max((i - 1) * sh, 0); y < y_end; ++y) {
      int i0, i1;
      float wy0, wy1;
      taps_of(y, h, H, i0, i1, wy0, wy1);
      const float wy = (i0 == i ? wy0 : 0.f) + (i1 == i ? wy1 : 0.f);
      if (wy == 0.f) continue;  // the same for the whole block
      // the row pair interpolated once, for the columns this warp reaches,
      // and scaled by log2 e for the exp2 below
      const float4* r0 = reinterpret_cast<const float4*>(rows + (i0 - i + 1) * srow + jlo * cs);
      const float4* r1 = reinterpret_cast<const float4*>(rows + (i1 - i + 1) * srow + jlo * cs);
      const float a0 = wy0 * kLog2e, a1 = wy1 * kLog2e;
      __syncwarp();
      for (int t = lane; t < ncell4; t += 32) {
        const float4 p = r0[t], q = r1[t];
        reinterpret_cast<float4*>(vbuf)[t] = make_float4(
            a0 * p.x + a1 * q.x, a0 * p.y + a1 * q.y, a0 * p.z + a1 * q.z, a0 * p.w + a1 * q.w);
      }
      __syncwarp();
      const size_t base = (static_cast<size_t>(b) * H + y) * W;
      for (int x = xa + lane; x < xb; x += 32) {
        const float px_w = wpx[base + x];
        if (px_w == 0.f) continue;  // an ignored pixel adds exactly 0
        const float g = wy * px_w;
        const int label = labels[base + x];
        const float l2 = lse[base + x] * kLog2e;
        const int jj = tj[x];
        const float* v0 = vbuf + ((jj & 0xffff) - jlo) * cs;
        const float* v1 = vbuf + ((jj >> 16) - jlo) * cs;
        const float wx0 = tw0[x], wx1 = tw1[x];
        float* ap = acc + x;
        // a batch of classes at a time, every load before the first store,
        // so that the loads of one batch are in flight together
        int k0 = 0;
        for (; k0 + kBwdBatch <= c; k0 += kBwdBatch) {
          float e[kBwdBatch], a[kBwdBatch];
          softmax8(v0 + k0, v1 + k0, wx0, wx1, l2, e);
#pragma unroll
          for (int u = 0; u < kBwdBatch; ++u) a[u] = ap[(k0 + u) * pitch];
#pragma unroll
          for (int u = 0; u < kBwdBatch; ++u) ap[(k0 + u) * pitch] = fmaf(g, e[u], a[u]);
        }
        if (k0 < c) {  // the last, partial batch (the rows are padded past it)
          float e[kBwdBatch];
          softmax8(v0 + k0, v1 + k0, wx0, wx1, l2, e);
#pragma unroll
          for (int u = 0; u < kBwdBatch; ++u)
            if (k0 + u < c) ap[(k0 + u) * pitch] += g * e[u];
        }
        // softmax - onehot: the label's class (a weighted pixel's label is valid)
        if (static_cast<unsigned>(label) < static_cast<unsigned>(c)) ap[label * pitch] -= g;
      }
    }
  }
  __syncthreads();

  // Phase 2, once a block: d_lr[i][j][k] = sum_x R_w[x, j] acc[k][x]; each
  // (j, k) has one owner thread and a fixed order of x.
  float* out = dlr + (static_cast<size_t>(b) * h + i) * w * c;
  for (int p = threadIdx.x; p < w * c; p += blockDim.x) {
    const int j = p / c, k = p - j * c;
    const int t0 = (2 * j - 1) * sw;
    const int x_lo = t0 > 0 ? t0 / 2 : 0, x_hi = min((2 * j + 3) * sw / 2, W);
    const float* a = acc + k * pitch;
    float sum = 0.f;
    if (j >= 1 && j <= w - 2) {
      for (int x = x_lo; x < x_hi; ++x) sum += wtab[x - x_lo] * a[x];
    } else {  // an edge column: its clamped taps as taps_of gives them
      for (int x = x_lo; x < x_hi; ++x) {
        const int jj = tj[x];
        const float wx = ((jj & 0xffff) == j ? tw0[x] : 0.f) + ((jj >> 16) == j ? tw1[x] : 0.f);
        sum += wx * a[x];
      }
    }
    out[p] = sum;
  }
}

inline size_t fwd_smem_bytes(int w, int c, int W) {
  return (2 * static_cast<size_t>(w) * c + 4 * static_cast<size_t>(W)) * sizeof(float);
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
// the backward packs a column's two taps into 16 bits each
inline bool bad_bwd_shape(int w) { return w > 32767; }

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

// Shared memory a backward block needs, in bytes, for the wrapper's check.
extern "C" long long upsample_ce_backward_smem_bytes(int w, int c, int W) {
  return static_cast<long long>(dlk::bwd_plan(w, c, W, dlk::kBwdThreads / 32).floats *
                                sizeof(float));
}

extern "C" int upsample_ce_backward(const void* logits, const void* labels, const void* wpx,
                                    const void* lse, void* dlr, int b, int h, int w, int c,
                                    int H, int W, void* stream) {
  if (dlk::bad_shape(b, h, w, c, H, W) || dlk::bad_bwd_shape(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dlk::bwd_plan(w, c, W, dlk::kBwdThreads / 32).floats * sizeof(float);
  cudaError_t err = dlk::allow_smem(dlk::upsample_ce_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dlk::upsample_ce_bwd_kernel<<<dim3(h, b), dlk::kBwdThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(wpx), static_cast<const float*>(lse),
      static_cast<float*>(dlr), h, w, c, H, W);
  return static_cast<int>(cudaGetLastError());
}
