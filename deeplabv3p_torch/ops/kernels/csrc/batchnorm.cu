// Training-mode BatchNorm (models.layers.BatchNorm in training): one forward
// and one backward a site, bf16 or f32 in and out with f32 statistics (f64
// with f64 statistics, for the parity checks that train in f64).
//
// Replaces no Pallas TPU kernel: the JAX package leaves BatchNorm to XLA,
// which fuses it into a few passes. The port's eager version widened x to f32
// and ran ~16 element-wise and reduction launches a site forward and as many
// again in autograd's backward, keeping x in f32 and x - mean for the backward
// (8 B an element). This computes what it computed (flax `_compute_stats`):
//   forward:  mean = S1 / n, var = max(S2 / n - mean^2, 0) over N, H, W, with
//             S1 = sum x, S2 = sum x^2 in f32; y = (x - mean) * (rsqrt(var +
//             eps) * w) + b in f32, rounded to x's type; the running buffers
//             r = m r + (1 - m) batch, in place, when asked;
//   backward: with xh = (x - mean) rstd, G1 = sum dy, G2 = sum dy xh:
//             dx = rstd w (dy - G1 / n - xh G2 / n), the last term dropped in a
//             channel whose raw variance was below 0 (clamp_min's gradient);
//             dw = G2, db = G1 over this process's elements.
// A data-parallel caller all-reduces the (2C + 1)-float vector [S1, S2, n]
// (forward) or [G1, G2, n] (backward) between the reduction and the apply
// (ops/kernels/batchnorm.py); the kernels do not know about ranks.
//
// Bound: bytes. The forward reads x twice and writes y; the backward reads x
// and dy twice and writes dx: 16 B an element in bf16 (32 in f32). At the
// main paths' sites (mnv2 OS16 at 512 px b16: 0.97 G elements a step over 65
// sites; Xception-65 OS8 b8: 3.82 G over 146) that is 4.6 and 18.2 ms a step
// at 3.35 TB/s. The per-block partial sums add 8 B a channel a block (under
// 1/32 of what the block reads, ops/kernels/batchnorm.py: launch_plan).
//
// Design. Layout channels_last, i.e. a (rows, C) matrix with rows = N H W.
// A thread owns V consecutive channels (V = 8 bf16 or 4 f32: 16-byte loads;
// V = 1 when C is no multiple of it or a pointer is not 16-byte aligned) and
// walks rows row_threads apart, four rows in flight; `lanes` (at most 32)
// threads cover a tile of lanes * V channels of a row, so a warp reads
// consecutive bytes. Three launches a direction:
//   1. bn_stats_kernel: each block (a run of rows x a channel tile) sums its
//      rows into registers, then its threads' sums in shared memory, in a
//      fixed order, and writes one partial [sum a, sum b] a channel;
//   2. bn_reduce_kernel: sums the blocks' partials column by column in a
//      fixed order into the (2C + 1) vector (n last);
//   3. bn_forward_apply_kernel / bn_backward_apply_kernel: every thread forms
//      its channels' coefficients from the vector (the forward's first row
//      block also writes mean, rstd and the clamp flag for the backward and
//      moves the running buffers), then normalises its rows.
// No float atomics anywhere: two calls give the same bits. The statistics use
// the _rn intrinsics where the eager version rounded each operation, so the
// clamp decision is the eager formula's on the same sums. A is the type of
// every sum and statistic: float for f32 and bf16 storage, double for f64.

#include "common.cuh"

namespace dlk {

constexpr int kFloat64 = 2;          // the third dtype code (ops/kernels/batchnorm.py)
constexpr int kBnThreads = 256;      // threads a block, at most
constexpr int kBnReduceRows = 16;    // row groups of bn_reduce_kernel's blocks

struct BnGeometry {
  long long rows;       // N * H * W
  int channels;         // C
  int lanes;            // threads across a tile's channel groups (<= 32)
  int row_threads;      // threads across rows; lanes * row_threads <= 256
  int rows_per_block;   // rows a block walks
};

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ double to_f64(double v) { return v; }
template <typename A, typename T> __device__ __forceinline__ A to_acc(T v) {
  if constexpr (sizeof(A) == 8) return to_f64(v); else return to_f32(v);
}
template <typename T, typename A> __device__ __forceinline__ T from_acc(A v) {
  if constexpr (sizeof(A) == 8) return v; else return from_f32<T>(v);
}

// one rounding each, never contracted into an FMA, in either type
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_(double a) { return rsqrt(a); }

// V values of T at p in A: one 16-byte access when V values are 16 bytes
// (the wrapper checks the alignment), else V scalar ones.
template <typename T, int V, typename A>
__device__ __forceinline__ void load_pack(const T* p, A (&out)[V]) {
  if constexpr (sizeof(T) * V == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_acc<A>(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_acc<A>(p[j]);
  }
}

template <typename T, int V, typename A>
__device__ __forceinline__ void store_pack(T* p, const A (&in)[V]) {
  if constexpr (sizeof(T) * V == 16) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = from_acc<T>(in[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = from_acc<T>(in[j]);
  }
}

// Forward: a = x, sums [x, x^2]. Backward: a = x, b = dy, sums [dy, dy xh].
template <bool kGrad, int V, typename A>
__device__ __forceinline__ void accumulate(const A (&a)[V], const A (&b)[V], const A (&mean)[V],
                                           const A (&rstd)[V], A (&s)[V], A (&q)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (kGrad) {
      const A xh = mul_rn(sub_rn(a[j], mean[j]), rstd[j]);
      s[j] += b[j];
      q[j] = fma_(b[j], xh, q[j]);
    } else {
      s[j] += a[j];
      q[j] = fma_(a[j], a[j], q[j]);
    }
  }
}

// partials[blockIdx.x][0 or 1][C]: this block's rows' two sums a channel of
// its tile (blockIdx.y).
template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kBnThreads)
bn_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const typename AccOf<T>::type* __restrict__ saved,
                typename AccOf<T>::type* __restrict__ partials, BnGeometry g) {
  using A = typename AccOf<T>::type;
  __shared__ A red[2 * kBnThreads * V];  // [row_threads][2][width]
  const int C = g.channels;
  const int tg = threadIdx.x % g.lanes, ry = threadIdx.x / g.lanes;
  const int width = g.lanes * V;
  const int c0 = blockIdx.y * width + tg * V;
  const bool active = c0 < C;  // C % V == 0: all V channels or none
  A s[V], q[V], mean[V], rstd[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s[j] = 0;
    q[j] = 0;
    mean[j] = 0;
    rstd[j] = 0;
  }
  if (active) {
    if (kGrad) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mean[j] = saved[c0 + j];
        rstd[j] = saved[C + c0 + j];
      }
    }
    const long long r1 = min(g.rows, static_cast<long long>(blockIdx.x + 1) * g.rows_per_block);
    const long long step = g.row_threads;
    long long r = static_cast<long long>(blockIdx.x) * g.rows_per_block + ry;
    for (; r + 3 * step < r1; r += 4 * step) {
      A a[4][V], b[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long off = (r + u * step) * C + c0;
        load_pack<T, V>(x + off, a[u]);
        if (kGrad) load_pack<T, V>(dy + off, b[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate<kGrad, V>(a[u], b[u], mean, rstd, s, q);
    }
    for (; r < r1; r += step) {
      A a[V], b[V];
      const long long off = r * C + c0;
      load_pack<T, V>(x + off, a);
      if (kGrad) load_pack<T, V>(dy + off, b);
      accumulate<kGrad, V>(a, b, mean, rstd, s, q);
    }
  }
  A* mine = red + ry * 2 * width;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mine[tg * V + j] = s[j];
    mine[width + tg * V + j] = q[j];
  }
  __syncthreads();
  A* out = partials + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int e = threadIdx.x; e < 2 * width; e += blockDim.x) {
    const int stat = e >= width;
    const int c = blockIdx.y * width + e - stat * width;
    if (c >= C) continue;
    A t = 0;
    for (int i = 0; i < g.row_threads; ++i) t += red[i * 2 * width + e];
    out[stat * C + c] = t;
  }
}

// sums[j] = sum over p of partials[p][j], j < 2C, in a fixed order; sums[2C] = n.
template <typename A>
__global__ void __launch_bounds__(32 * kBnReduceRows)
bn_reduce_kernel(const A* __restrict__ partials, A* __restrict__ sums, int parts, int width,
                 A n) {
  __shared__ A red[kBnReduceRows][32];
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  A t = 0;
  if (col < width) {
#pragma unroll 4
    for (int p = rg; p < parts; p += kBnReduceRows) t += partials[static_cast<size_t>(p) * width + col];
  }
  red[rg][lane] = t;
  __syncthreads();
  if (rg == 0 && col < width) {
    A u = 0;
#pragma unroll
    for (int i = 0; i < kBnReduceRows; ++i) u += red[i][lane];
    sums[col] = u;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) sums[width] = n;
}

// y = (x - mean) * (rstd * w) + b from the (2C + 1) vector [S1, S2, n].
// Row block 0 also writes saved = [mean, rstd, keep] (keep = 1 where the raw
// variance is >= 0) and, with `update`, moves the (f32) running buffers.
template <typename T, int V>
__global__ void __launch_bounds__(kBnThreads)
bn_forward_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                        const typename AccOf<T>::type* __restrict__ sums,
                        const float* __restrict__ weight, const float* __restrict__ bias,
                        typename AccOf<T>::type* __restrict__ saved,
                        float* __restrict__ running_mean, float* __restrict__ running_var,
                        double eps, double keep_frac, double new_frac, int update,
                        BnGeometry g) {
  using A = typename AccOf<T>::type;
  const int C = g.channels;
  const int tg = threadIdx.x % g.lanes, ry = threadIdx.x / g.lanes;
  const int c0 = blockIdx.y * g.lanes * V + tg * V;
  if (c0 >= C) return;
  const A n = sums[2 * C];
  A mean[V], mul[V], shift[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j;
    const A m = div_rn(sums[c], n);
    const A raw = sub_rn(div_rn(sums[C + c], n), mul_rn(m, m));
    const A var = raw < A(0) ? A(0) : raw;  // clamp_min: a NaN stays NaN
    const A rstd = rsqrt_(add_rn(var, static_cast<A>(eps)));
    mean[j] = m;
    mul[j] = mul_rn(rstd, static_cast<A>(weight[c]));
    shift[j] = bias[c];
    if (blockIdx.x == 0 && ry == 0) {
      saved[c] = m;
      saved[C + c] = rstd;
      saved[2 * C + c] = raw >= A(0) ? A(1) : A(0);
      if (update) {
        const float kf = static_cast<float>(keep_frac), nf = static_cast<float>(new_frac);
        running_mean[c] = fmaf(nf, static_cast<float>(m), __fmul_rn(running_mean[c], kf));
        running_var[c] = fmaf(nf, static_cast<float>(var), __fmul_rn(running_var[c], kf));
      }
    }
  }
  const long long r1 = min(g.rows, static_cast<long long>(blockIdx.x + 1) * g.rows_per_block);
  const long long step = g.row_threads;
  long long r = static_cast<long long>(blockIdx.x) * g.rows_per_block + ry;
  for (; r + 3 * step < r1; r += 4 * step) {
    A a[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_pack<T, V>(x + (r + u * step) * C + c0, a[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) a[u][j] = add_rn(mul_rn(sub_rn(a[u][j], mean[j]), mul[j]), shift[j]);
      store_pack<T, V>(y + (r + u * step) * C + c0, a[u]);
    }
  }
  for (; r < r1; r += step) {
    A a[V];
    load_pack<T, V>(x + r * C + c0, a);
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = add_rn(mul_rn(sub_rn(a[j], mean[j]), mul[j]), shift[j]);
    store_pack<T, V>(y + r * C + c0, a);
  }
}

// dx = rstd w (dy - G1 / n - keep xh G2 / n) from the (2C + 1) vector [G1, G2, n].
template <typename T, int V>
__global__ void __launch_bounds__(kBnThreads)
bn_backward_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx,
                         const typename AccOf<T>::type* __restrict__ sums,
                         const typename AccOf<T>::type* __restrict__ saved,
                         const float* __restrict__ weight, BnGeometry g) {
  using A = typename AccOf<T>::type;
  const int C = g.channels;
  const int tg = threadIdx.x % g.lanes, ry = threadIdx.x / g.lanes;
  const int c0 = blockIdx.y * g.lanes * V + tg * V;
  if (c0 >= C) return;
  const A n = sums[2 * C];
  A mean[V], rstd[V], mul[V], mdy[V], mdyx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j;
    mean[j] = saved[c];
    rstd[j] = saved[C + c];
    mul[j] = mul_rn(rstd[j], static_cast<A>(weight[c]));
    mdy[j] = div_rn(sums[c], n);
    mdyx[j] = saved[2 * C + c] != A(0) ? div_rn(sums[C + c], n) : A(0);
  }
  const long long r1 = min(g.rows, static_cast<long long>(blockIdx.x + 1) * g.rows_per_block);
  const long long step = g.row_threads;
  long long r = static_cast<long long>(blockIdx.x) * g.rows_per_block + ry;
  for (; r + 3 * step < r1; r += 4 * step) {
    A a[4][V], b[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long off = (r + u * step) * C + c0;
      load_pack<T, V>(x + off, a[u]);
      load_pack<T, V>(dy + off, b[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const A xh = mul_rn(sub_rn(a[u][j], mean[j]), rstd[j]);
        a[u][j] = mul[j] * fma_(-xh, mdyx[j], b[u][j] - mdy[j]);
      }
      store_pack<T, V>(dx + (r + u * step) * C + c0, a[u]);
    }
  }
  for (; r < r1; r += step) {
    A a[V], b[V];
    const long long off = r * C + c0;
    load_pack<T, V>(x + off, a);
    load_pack<T, V>(dy + off, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const A xh = mul_rn(sub_rn(a[j], mean[j]), rstd[j]);
      a[j] = mul[j] * fma_(-xh, mdyx[j], b[j] - mdy[j]);
    }
    store_pack<T, V>(dx + off, a);
  }
}

template <typename T, int V>
struct BnTag {
  using type = T;
  using acc = typename AccOf<T>::type;
  static constexpr int vec = V;
};

// Runs f(BnTag<T, V>{}) for the storage type code and vector width, the
// wide width being 16 bytes of T.
template <typename F>
int bn_dispatch(int dtype, int vec, F f) {
  if (dtype == kFloat32 && vec == 4) return f(BnTag<float, 4>{});
  if (dtype == kFloat32 && vec == 1) return f(BnTag<float, 1>{});
  if (dtype == kBFloat16 && vec == 8) return f(BnTag<__nv_bfloat16, 8>{});
  if (dtype == kBFloat16 && vec == 1) return f(BnTag<__nv_bfloat16, 1>{});
  if (dtype == kFloat64 && vec == 2) return f(BnTag<double, 2>{});
  if (dtype == kFloat64 && vec == 1) return f(BnTag<double, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

inline bool bn_bad_plan(int vec, long long rows, int channels, int lanes, int row_threads,
                        int rows_per_block, int blocks, int tiles) {
  return rows < 0 || channels <= 0 || vec < 1 || lanes < 1 || lanes > 32 ||
         row_threads < 1 || lanes * row_threads > kBnThreads || rows_per_block < 1 ||
         blocks < 1 || tiles < 1 || tiles > 65535 || channels % vec != 0 ||
         static_cast<long long>(tiles) * lanes * vec < channels ||
         static_cast<long long>(blocks) * rows_per_block < rows;
}

}  // namespace dlk

// The C interface: one call a direction runs its three launches on
// `stream`, or, with `phase` 1 then 2, the first two (the reduction into
// `sums`) and the last (the apply) apart, for a caller that all-reduces
// `sums` in between. x, y, dy and dx are (rows, C) channels_last, f32 (dtype
// 0), bf16 (1) or f64 (2), `vec` 1 or 16 bytes of the type; partials (blocks
// x 2C), sums (2C + 1) and saved = [mean, rstd, keep] (3C) are f32, f64 for
// f64; weight, bias and the running buffers f32 (C). Each returns a
// cudaError_t (0 on success).

namespace dlk {

constexpr int kPhaseSums = 1;
constexpr int kPhaseApply = 2;

template <typename T, int V, bool kGrad>
cudaError_t launch_sums(const T* x, const T* dy, const typename AccOf<T>::type* saved,
                        typename AccOf<T>::type* partials, typename AccOf<T>::type* sums,
                        int blocks, int tiles, int threads, const BnGeometry& g,
                        cudaStream_t s) {
  using A = typename AccOf<T>::type;
  bn_stats_kernel<T, V, kGrad><<<dim3(blocks, tiles), threads, 0, s>>>(x, dy, saved, partials, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = 2 * g.channels;
  bn_reduce_kernel<A><<<(width + 31) / 32, 32 * kBnReduceRows, 0, s>>>(
      partials, sums, blocks, width, static_cast<A>(g.rows));
  return cudaGetLastError();
}

}  // namespace dlk

extern "C" int bn_forward(const void* x, void* y, void* partials, void* sums, const void* weight,
                          const void* bias, void* saved, void* running_mean, void* running_var,
                          double eps, double momentum, int update, int phase, int dtype, int vec,
                          long long rows, int channels, int lanes, int row_threads,
                          int rows_per_block, int blocks, int tiles, void* stream) {
  if (dlk::bn_bad_plan(vec, rows, channels, lanes, row_threads, rows_per_block, blocks, tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const dlk::BnGeometry g{rows, channels, lanes, row_threads, rows_per_block};
  const int threads = lanes * row_threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dlk::bn_dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    using A = typename decltype(tag)::acc;
    constexpr int V = decltype(tag)::vec;
    if (phase & dlk::kPhaseSums) {
      const cudaError_t err = dlk::launch_sums<T, V, false>(
          static_cast<const T*>(x), nullptr, nullptr, static_cast<A*>(partials),
          static_cast<A*>(sums), blocks, tiles, threads, g, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (phase & dlk::kPhaseApply) {
      dlk::bn_forward_apply_kernel<T, V><<<dim3(blocks, tiles), threads, 0, s>>>(
          static_cast<const T*>(x), static_cast<T*>(y), static_cast<const A*>(sums),
          static_cast<const float*>(weight), static_cast<const float*>(bias),
          static_cast<A*>(saved), static_cast<float*>(running_mean),
          static_cast<float*>(running_var), eps, momentum, 1.0 - momentum, update, g);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// `sums` takes this process's [sum dy, sum dy xh, n] (dweight and dbias are
// its halves); the apply reads `total`, the same vector all-reduced (or
// `sums` itself). dx == nullptr skips the apply.
extern "C" int bn_backward(const void* dy, const void* x, void* dx, void* partials, void* sums,
                           const void* total, const void* saved, const void* weight, int phase,
                           int dtype, int vec, long long rows, int channels, int lanes,
                           int row_threads, int rows_per_block, int blocks, int tiles,
                           void* stream) {
  if (dlk::bn_bad_plan(vec, rows, channels, lanes, row_threads, rows_per_block, blocks, tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const dlk::BnGeometry g{rows, channels, lanes, row_threads, rows_per_block};
  const int threads = lanes * row_threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dlk::bn_dispatch(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    using A = typename decltype(tag)::acc;
    constexpr int V = decltype(tag)::vec;
    if (phase & dlk::kPhaseSums) {
      const cudaError_t err = dlk::launch_sums<T, V, true>(
          static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const A*>(saved),
          static_cast<A*>(partials), static_cast<A*>(sums), blocks, tiles, threads, g, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if ((phase & dlk::kPhaseApply) && dx != nullptr) {
      dlk::bn_backward_apply_kernel<T, V><<<dim3(blocks, tiles), threads, 0, s>>>(
          static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<T*>(dx),
          static_cast<const A*>(total), static_cast<const A*>(saved),
          static_cast<const float*>(weight), g);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
