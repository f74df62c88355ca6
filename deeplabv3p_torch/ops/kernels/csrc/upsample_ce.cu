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
// 81-84 us by CUDA events (187-189 us before its redesign) and the backward
// 255 us (786-798 us before its; PERF.md has the table and what was tried).
//
// Forward design: one block per pair of low-resolution rows (b, g - 1, g),
// h + 1 pairs a map, which walks the s full-resolution rows whose taps are
// that pair (the two edge pairs, whose taps clamp, have s / 2 rows). The pair
// is read once instead of s times, and never staged: a thread loads 4
// consecutive classes of a column of both rows from device memory (L2), 4
// such items at a time with every load before the first store, and writes
// every row of the group interpolated ONCE, v[r][j][k] = wy0 r0 + wy1 r1, as
// 16-byte stores into a shared (rows, w, C') buffer, C' = C padded to 28
// floats at C = 21 so that a pixel's classes load as 16-byte vectors without
// bank conflicts. For an integer scale the sample's index and fraction follow
// from integer arithmetic (phase_of), so the row and column weights are two
// tables of s entries, not a table of W entries filled by every block.
// A thread takes 4 consecutive pixels of a row at a time: their labels and
// weights come and their preds and lse go as 16-byte accesses (the faster on
// the card: 90 against 104 us at that stage of the work; rows whose width is
// no multiple of 4 take 4-byte ones), and their columns of the buffer are
// held in registers and shared along the run, 18 16-byte loads for 4 pixels
// at scale 4 where pixel-at-a-time took 48. A pixel's classes are held in
// registers, 8 at a time up to 32 (a template on the number of batches; above
// 32 classes a batch-at-a-time loop rescales the sum once a batch): pass 1
// the max and the strict-greater argmax in natural units, pass 2 sum exp2((z
// - m) log2 e) by ex2.approx, then one lg2; no data-dependent branch. The
// label's logit is recomputed once a pixel. 128 registers a thread, 57.4 KB a
// block, two blocks an SM at the slice. When B (h + 1) is short of two blocks
// an SM (the lite head's scale 16), the rows of a pair are split over
// blockIdx.z; when a group's rows exceed 64 KB of buffer the block walks them
// in chunks. The loss is reduced without float atomics, in a fixed order:
// each block sums its pixels (warp shuffles, then across warps) into one
// partial, and a second kernel of this file sums the partials in one block:
// two calls give the same bits. JAX carries the sum across its sequential grid
// instead. The forward also writes the per-pixel lse (16 MB at the slice) so
// the backward needs one class pass a pixel instead of two (the Pallas
// backward recomputes it).
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

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Floats between two columns' classes in a row-interpolated buffer: C padded to
// whole batches of 8 classes (16-byte loads), then to an odd number of 16-byte
// units (8 neighbouring columns then cover all 32 banks).
__host__ __device__ inline int padded_classes(int c) {
  int cs = (c + kBwdBatch - 1) / kBwdBatch * kBwdBatch;
  if ((cs / 4) % 2 == 0) cs += 4;
  return cs;
}

// The forward's plan, for the kernel and the host.
struct FwdPlan {
  int cs;         // padded_classes(C)
  int split;      // blocks that share the full-resolution rows of one row pair
  int per;        // rows of a pair a block owns, at most
  int chunk;      // rows a block interpolates at a time (its buffer's rows)
  size_t floats;  // dynamic shared memory: the buffer and the two phase tables
};

constexpr int kFwdItems = 4;   // 16-byte items of a row pair a thread loads before it stores
constexpr int kFwdPixels = 4;  // consecutive pixels of a row a thread owns (1 or 4)
constexpr int kFwdBlocksWanted = 2 * 132;       // two blocks for every SM of the card
constexpr size_t kFwdBufferFloats = 64 * 1024 / sizeof(float);  // a block's buffer, at most

inline FwdPlan fwd_plan(int b, int h, int w, int c, int H, int W) {
  FwdPlan p;
  const int sh = H / h, sw = W / w;
  p.cs = padded_classes(c);
  const long long pairs = static_cast<long long>(b) * (h + 1);
  long long split = (kFwdBlocksWanted + pairs - 1) / pairs;
  p.split = static_cast<int>(split < sh ? split : sh);
  p.per = (sh + p.split - 1) / p.split;
  const size_t row = static_cast<size_t>(w) * p.cs;
  size_t fit = kFwdBufferFloats / row;
  if (fit < 1) fit = 1;
  p.chunk = static_cast<int>(fit < static_cast<size_t>(p.per) ? fit : p.per);
  p.floats = p.chunk * row + 2 * static_cast<size_t>(sh) + 2 * static_cast<size_t>(sw);
  return p;
}

// A column's NB * 8 classes of the row-interpolated buffer, to registers.
template <int NB>
__device__ __forceinline__ void load_column(const float* p, float (&v)[(NB > 0 ? NB : 1) * kBwdBatch]) {
#pragma unroll
  for (int k0 = 0; k0 < NB * kBwdBatch; k0 += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + k0);
    v[k0] = a.x, v[k0 + 1] = a.y, v[k0 + 2] = a.z, v[k0 + 3] = a.w;
  }
}

// One pixel's classes from its two columns a and d, two passes over z held in
// registers (NB batches of 8): the max and the strict-greater argmax in natural
// units (ties keep the lower class, near-ties resolve as the plain version's),
// then sum exp2((z - m) log2 e).
template <int NB>
__device__ __forceinline__ void pixel_classes(const float (&a)[NB * kBwdBatch],
                                              const float (&d)[NB * kBwdBatch], float wx0,
                                              float wx1, int c, float& m, int& best,
                                              float& s) {
  float z[NB * kBwdBatch];
#pragma unroll
  for (int u = 0; u < NB * kBwdBatch; ++u) z[u] = fmaf(wx0, a[u], wx1 * d[u]);
#pragma unroll
  for (int u = (NB - 1) * kBwdBatch; u < NB * kBwdBatch; ++u)
    if (u >= c) z[u] = -CUDART_INF_F;  // the padding of the last batch
  m = -CUDART_INF_F;
  best = 0;
#pragma unroll
  for (int u = 0; u < NB * kBwdBatch; ++u) {
    const bool up = z[u] > m;  // strict: ties keep the lower class index
    m = up ? z[u] : m;
    best = up ? u : best;
  }
  const float ml = -m * kLog2e;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int u = 0; u < NB * kBwdBatch; u += 2) {
    s0 += exp2_approx(fmaf(z[u], kLog2e, ml));
    s1 += exp2_approx(fmaf(z[u + 1], kLog2e, ml));
  }
  s = s0 + s1;
}

// Any class count, from the buffer: a batch of 8 at a time, the running sum
// rescaled once a batch (one more exp2 a batch, no data-dependent branch).
__device__ __forceinline__ void pixel_classes_batched(const float* p, const float* q, float wx0,
                                                      float wx1, int c, float& m, int& best,
                                                      float& s) {
  m = -CUDART_INF_F;
  best = 0;
  s = 0.f;
  for (int k0 = 0; k0 < c; k0 += kBwdBatch) {
    float z[kBwdBatch];
#pragma unroll
    for (int u = 0; u < kBwdBatch; u += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + k0 + u);
      const float4 d = *reinterpret_cast<const float4*>(q + k0 + u);
      z[u] = fmaf(wx0, a.x, wx1 * d.x);
      z[u + 1] = fmaf(wx0, a.y, wx1 * d.y);
      z[u + 2] = fmaf(wx0, a.z, wx1 * d.z);
      z[u + 3] = fmaf(wx0, a.w, wx1 * d.w);
    }
    float bm = m;
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      if (k0 + u >= c) z[u] = -CUDART_INF_F;
      const bool up = z[u] > bm;
      bm = up ? z[u] : bm;
      best = up ? k0 + u : best;
    }
    const float bl = -bm * kLog2e;
    // m = -inf (the first batch): exp2(-inf) = 0 times s = 0
    float t = s * exp2_approx(fmaf(m, kLog2e, bl));
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) t += exp2_approx(fmaf(z[u], kLog2e, bl));
    s = t;
    m = bm;
  }
}

// Index and phase of the half-pixel sample at output coordinate o for an
// integer scale s: floor((o + 0.5) / s - 0.5) = floor((o - s / 2) / s) in
// integers, and the fraction depends on the remainder alone.
__device__ __forceinline__ void phase_of(int o, int s, int& fl, int& d) {
  const int t = o - s / 2 + s;  // >= 0
  fl = t / s - 1;
  d = t - (fl + 1) * s;
}

// PX consecutive pixels of a row as one 4- or 16-byte access
template <int PX, typename T>
__device__ __forceinline__ void load_px(const T* p, T (&v)[PX]) {
  if constexpr (PX == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    const int raw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const T*>(&raw[u]);
  } else {
    v[0] = *p;
  }
}

template <int PX, typename T>
__device__ __forceinline__ void store_px(T* p, const T (&v)[PX]) {
  if constexpr (PX == 4) {
    int raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) raw[u] = *reinterpret_cast<const int*>(&v[u]);
    *reinterpret_cast<int4*>(p) = make_int4(raw[0], raw[1], raw[2], raw[3]);
  } else {
    *p = v[0];
  }
}

// grid (h + 1, B, split), block kCeThreads, dynamic shared memory and cs, per,
// chunk from fwd_plan(). The block owns (a share of) the full-resolution rows
// whose two taps are the low-resolution rows g - 1 and g (clamped).
template <int NB, int PX>
__global__ void __launch_bounds__(kCeThreads, 2)
    upsample_ce_fwd_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
                           const float* __restrict__ wpx, int* __restrict__ preds,
                           float* __restrict__ lse_out, float* __restrict__ partial, int h,
                           int w, int c, int H, int W, int cs, int per, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x, b = blockIdx.y;
  const int sh = H / h, sw = W / w;
  float* vbuf = smem;                          // (chunk, w, cs): rows interpolated vertically
  float* wrow = vbuf + chunk * w * cs;          // (w0, w1) of each row phase
  float* wcol = wrow + 2 * sh;                 // ... and of each column phase

  // interp_matrix's weights (1 - frac, frac) with frac = (d + 0.5) / s for an
  // even scale and d / s for an odd one: both are ratios of small integers, so
  // one correctly rounded f32 division each gives them to the last bit
  for (int d = threadIdx.x; d < sh + sw; d += blockDim.x) {
    const int s = d < sh ? sh : sw, dd = d < sh ? d : d - sh;
    const int num = s % 2 == 0 ? 2 * dd + 1 : 2 * dd;  // frac = num / (2 s)
    float* tab = d < sh ? wrow + 2 * dd : wcol + 2 * dd;
    tab[0] = static_cast<float>(2 * s - num) / static_cast<float>(2 * s);
    tab[1] = static_cast<float>(num) / static_cast<float>(2 * s);
  }
  // the rows y with floor((y + 0.5) / sh - 0.5) = g - 1, this block's share
  const int ya = max((g - 1) * sh + sh / 2, 0), yb = min(g * sh + sh / 2, H);
  const int y_lo = min(ya + static_cast<int>(blockIdx.z) * per, yb);
  const int y_hi = min(y_lo + per, yb);
  const int i0 = max(g - 1, 0), i1 = min(g, h - 1);
  const float* src0 = logits + (static_cast<size_t>(b) * h + i0) * w * c;
  const float* src1 = logits + (static_cast<size_t>(b) * h + i1) * w * c;
  const int srow = w * cs;
  __syncthreads();

  float acc = 0.f;
  for (int y0 = y_lo; y0 < y_hi; y0 += chunk) {
    const int rows = min(chunk, y_hi - y0);
    const int d0 = y0 - ((g - 1) * sh + sh / 2);  // row phase of y0
    // each row of the chunk interpolated once: v[r][j][k] = wy0 r0 + wy1 r1. A
    // thread takes 4 consecutive classes of a column as an item: 8 loads from
    // device memory (L2), then one 16-byte store a row; kFwdItems items at a
    // time, every load before the first store, so that a block waits for
    // device memory once and not once an item.
    const int quads = cs / 4, items = w * quads;
    for (int t0 = threadIdx.x; t0 < items; t0 += kFwdItems * blockDim.x) {
      float p0[kFwdItems][4], p1[kFwdItems][4];
      int at[kFwdItems];  // the item's offset in a row of the buffer
#pragma unroll
      for (int u = 0; u < kFwdItems; ++u) {
        const int t = t0 + u * blockDim.x;
        const int j = t / quads, k = (t - j * quads) * 4;
        at[u] = t < items ? j * cs + k : -1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = t < items && k + e < c;  // the padding is 0
          p0[u][e] = live ? src0[j * c + k + e] : 0.f;
          p1[u][e] = live ? src1[j * c + k + e] : 0.f;
        }
      }
      for (int r = 0; r < rows; ++r) {
        const float wy0 = wrow[2 * (d0 + r)], wy1 = wrow[2 * (d0 + r) + 1];
#pragma unroll
        for (int u = 0; u < kFwdItems; ++u) {
          if (at[u] < 0) continue;
          *reinterpret_cast<float4*>(vbuf + r * srow + at[u]) =
              make_float4(wy0 * p0[u][0] + wy1 * p1[u][0], wy0 * p0[u][1] + wy1 * p1[u][1],
                          wy0 * p0[u][2] + wy1 * p1[u][2], wy0 * p0[u][3] + wy1 * p1[u][3]);
        }
      }
    }
    __syncthreads();
    // a thread takes PX consecutive pixels at a time; the chunk's rows are
    // consecutive in labels, wpx, preds and lse, so group q is at base + q PX
    // (PX divides W: the launch function checks)
    const int nx = W / PX;
    const size_t base = (static_cast<size_t>(b) * H + y0) * W;
    for (int q = threadIdx.x; q < rows * nx; q += blockDim.x) {
      const int r = q / nx, x = (q - r * nx) * PX;
      const size_t px = base + static_cast<size_t>(q) * PX;
      int label[PX], best[PX];
      float px_w[PX], lse[PX];
      load_px<PX>(labels + px, label);
      load_px<PX>(wpx + px, px_w);
      const float* v = vbuf + r * srow;
      int fl, d;
      phase_of(x, sw, fl, d);
      // the pixel's two columns in registers; consecutive pixels mostly share
      // them, so each is loaded once a run (ca and cd name what a and e hold)
      float a[(NB > 0 ? NB : 1) * kBwdBatch], e[(NB > 0 ? NB : 1) * kBwdBatch];
      int ca = -1, cd = -1;
#pragma unroll
      for (int u = 0; u < PX; ++u) {
        const int off0 = max(fl, 0) * cs, off1 = min(fl + 1, w - 1) * cs;
        const float wx0 = wcol[2 * d], wx1 = wcol[2 * d + 1];
        // wpx is 0 at invalid labels: any class will do for them
        const int lk = static_cast<unsigned>(label[u]) < static_cast<unsigned>(c) ? label[u] : 0;
        float m, s;
        if constexpr (NB > 0) {
          if (off0 != ca) {
            if (off0 == cd) {
#pragma unroll
              for (int k = 0; k < NB * kBwdBatch; ++k) a[k] = e[k];
            } else {
              load_column<NB>(v + off0, a);
            }
            ca = off0;
          }
          if (off1 != cd) {
            load_column<NB>(v + off1, e);
            cd = off1;
          }
          pixel_classes<NB>(a, e, wx0, wx1, c, m, best[u], s);
        } else {
          pixel_classes_batched(v + off0, v + off1, wx0, wx1, c, m, best[u], s);
        }
        lse[u] = fmaf(__log2f(s), kLn2, m);
        // the label's logit, the same expression as z in pixel_classes
        const float zl = fmaf(wx0, v[off0 + lk], wx1 * v[off1 + lk]);
        acc += (lse[u] - zl) * px_w[u];
        if (++d == sw) d = 0, ++fl;  // the next column's phase
      }
      store_px<PX>(preds + px, best);
      store_px<PX>(lse_out + px, lse);
    }
    __syncthreads();
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0)
    partial[(static_cast<size_t>(b) * gridDim.x + g) * gridDim.z + blockIdx.z] = acc;
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
  int cs;         // padded_classes(C): floats between two columns' classes in the
                  // staged and interpolated rows
  int warp_px;    // pixels of a row a warp owns
  int vcols;      // low-resolution columns a warp's pixels can reach (upper bound)
  size_t floats;  // all of it
};

__host__ __device__ inline BwdPlan bwd_plan(int w, int c, int W, int warps) {
  BwdPlan p;
  p.pitch = W | 1;
  p.cs = padded_classes(c);
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

inline bool bad_shape(int b, int h, int w, int c, int H, int W) {
  return b < 1 || h < 1 || w < 1 || c < 1 || H % h != 0 || W % w != 0 || b > 65535;
}
// the backward packs a column's two taps into 16 bits each
inline bool bad_bwd_shape(int w) { return w > 32767; }

template <int NB, int PX>
cudaError_t launch_fwd_px(const float* logits, const int* labels, const float* wpx, int* preds,
                       float* lse, float* partial, float* loss, int b, int h, int w, int c,
                       int H, int W, cudaStream_t s) {
  const FwdPlan plan = fwd_plan(b, h, w, c, H, W);
  cudaError_t err = allow_smem(upsample_ce_fwd_kernel<NB, PX>, plan.floats * sizeof(float));
  if (err != cudaSuccess) return err;
  upsample_ce_fwd_kernel<NB, PX><<<dim3(h + 1, b, plan.split), kCeThreads,
                               plan.floats * sizeof(float), s>>>(
      logits, labels, wpx, preds, lse, partial, h, w, c, H, W, plan.cs, plan.per, plan.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kCeThreads, 0, s>>>(partial, b * (h + 1) * plan.split, loss);
  return cudaGetLastError();
}

// kFwdPixels consecutive pixels a thread where every row of labels, wpx, preds
// and lse starts on a 16-byte boundary, else one
template <int NB>
cudaError_t launch_fwd(const float* logits, const int* labels, const float* wpx, int* preds,
                       float* lse, float* partial, float* loss, int b, int h, int w, int c,
                       int H, int W, cudaStream_t s) {
  const auto bits = reinterpret_cast<uintptr_t>(labels) | reinterpret_cast<uintptr_t>(wpx) |
                    reinterpret_cast<uintptr_t>(preds) | reinterpret_cast<uintptr_t>(lse);
  if (kFwdPixels == 4 && W % 4 == 0 && bits % 16 == 0)
    return launch_fwd_px<NB, kFwdPixels>(logits, labels, wpx, preds, lse, partial, loss, b, h, w,
                                         c, H, W, s);
  return launch_fwd_px<NB, 1>(logits, labels, wpx, preds, lse, partial, loss, b, h, w, c, H, W,
                              s);
}

}  // namespace dlk

// Shared memory a forward block needs, in bytes, and the number of blocks
// (one partial loss sum each), for the wrapper's check and its scratch.
extern "C" long long upsample_ce_forward_smem_bytes(int b, int h, int w, int c, int H, int W) {
  if (dlk::bad_shape(b, h, w, c, H, W)) return -1;
  return static_cast<long long>(dlk::fwd_plan(b, h, w, c, H, W).floats * sizeof(float));
}

extern "C" long long upsample_ce_forward_blocks(int b, int h, int w, int c, int H, int W) {
  if (dlk::bad_shape(b, h, w, c, H, W)) return -1;
  return static_cast<long long>(b) * (h + 1) * dlk::fwd_plan(b, h, w, c, H, W).split;
}

// Both launch on `stream` (of the current device) and return a cudaError_t
// (0 on success). `partial` is scratch of upsample_ce_forward_blocks() floats;
// `loss` one float.
extern "C" int upsample_ce_forward(const void* logits, const void* labels, const void* wpx,
                                   void* preds, void* lse, void* partial, void* loss, int b,
                                   int h, int w, int c, int H, int W, void* stream) {
  if (dlk::bad_shape(b, h, w, c, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const float* lg = static_cast<const float*>(logits);
  const int* lb = static_cast<const int*>(labels);
  const float* wp = static_cast<const float*>(wpx);
  int* pr = static_cast<int*>(preds);
  float* ls = static_cast<float*>(lse);
  float* pa = static_cast<float*>(partial);
  float* lo = static_cast<float*>(loss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // batches of 8 classes a pixel holds in registers; above 32 classes the
  // batch-at-a-time kernel
  const int nb = c <= 4 * dlk::kBwdBatch ? (c + dlk::kBwdBatch - 1) / dlk::kBwdBatch : 0;
  cudaError_t err;
  switch (nb) {
    case 1: err = dlk::launch_fwd<1>(lg, lb, wp, pr, ls, pa, lo, b, h, w, c, H, W, s); break;
    case 2: err = dlk::launch_fwd<2>(lg, lb, wp, pr, ls, pa, lo, b, h, w, c, H, W, s); break;
    case 3: err = dlk::launch_fwd<3>(lg, lb, wp, pr, ls, pa, lo, b, h, w, c, H, W, s); break;
    case 4: err = dlk::launch_fwd<4>(lg, lb, wp, pr, ls, pa, lo, b, h, w, c, H, W, s); break;
    default: err = dlk::launch_fwd<0>(lg, lb, wp, pr, ls, pa, lo, b, h, w, c, H, W, s); break;
  }
  return static_cast<int>(err);
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
