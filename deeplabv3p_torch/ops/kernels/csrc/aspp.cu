// Multi-rate atrous depthwise 3x3 convolution with folded BN + ReLU.
//
// Replaces the Pallas TPU kernel deeplabv3p_tpu/ops/pallas/aspp.py:
// multirate_atrous_depthwise (body `_kernel`): the depthwise stage of the
// three ASPP separable branches (rates (6,12,18) at OS16), each
//   out[r] = relu(dwconv3x3(x, k[r], dilation=rates[r], SAME) * scale[r] + bias[r])
// from ONE pass over the input, accumulated in f32 and rounded once, at the
// store, to x's type (f32 or bf16).
//
// Bound: bytes. An output costs 9 multiply-adds and the BN fold; x is read
// once and R maps are written. At the serving path's (1,32,32,320) bf16,
// rates (6,12,18), that is 2.66 MB, 0.80 us at 3.35 TB/s, below one
// launch's own latency; at the eval path's batch 8 it is 21.0 MB, 6.27 us.
// So the design fills the card at batch 1 and streams at batch 8.
//
// Design (the plan is made once a call signature by ops/kernels/aspp.py,
// `launch_plan`, and handed over as an AsppPlan):
// * A thread owns V consecutive channels of one pixel, so that every x read
//   and every store is 16 bytes: V = 8 in bf16, 4 in f32. A channel count
//   that is no multiple of V (or a tensor that does not start on 16 bytes)
//   takes the V = 1 instantiation, one channel a thread.
// * A block owns (image, band of `band` output rows, group of G = nv * V
//   channels), G * sizeof(T) = 32 bytes where V > 1 (one sector a pixel). In
//   one round trip of cp.async copies it stages the input rows its band's
//   taps reach, at the full width, for its G channels, and the group's
//   weights, scale and bias. The rows are either the one range
//   [y0 - reach, y0 + band + reach) clipped to the map (reach = the largest
//   rate below H), or, where that is more, one band-high segment a
//   (rate, dy), the 2R+1 row sets {y + dy * r}. A rate >= H reaches only its
//   centre row, so it adds no segment. Every tap then comes from shared
//   memory: each input element is read from L2/HBM once a block. The copies
//   are one flat loop each, their indices by shifts and by a float-reciprocal
//   division (`Divider`): with a block's few tasks a thread, the index
//   arithmetic of the prologue costs as many instructions as the taps.
// * A thread takes one task a pass: (rate, row, column, vector), the rate
//   slowest. Lanes of a warp share the rate and the row, so the row tests are
//   uniform, the columns diverge only at the map's edges, a tap's 16-byte x
//   reads are consecutive in shared memory (4 wavefronts a warp, no bank
//   conflict) and its weights are one address for every lane of a vector (a
//   broadcast). Splitting the rates over threads keeps a thread's chain at
//   9 taps; the launch bound caps it at 64 registers, 4 blocks of 256 an SM.
// * The grid aims at 4 blocks an SM (`BLOCKS_PER_SM`). Serving shape
//   (1,32,32,320) bf16: 20 groups x 32 one-row bands = 640 blocks of 192
//   threads, segments of 7 rows, 9.1 KB of shared memory each. Eval shape
//   (8,32,32,320) bf16: 640 blocks of 8 rows, the whole 32-row map staged
//   (34 KB), 6 tasks a thread. OS8 (1,64,64,320): 640 blocks, segments of 2
//   rows, 30 KB. Dynamic shared memory above 48 KB; the wrapper refuses a
//   plan above 227 KB.
// * Offsets are 32-bit: the wrapper refuses outputs of 2^31 elements or more.

#include "common.cuh"

namespace dlk {

constexpr int kMaxRates = 4;

// The launch plan: ops/kernels/aspp.py `AsppPlan` mirrors this field for
// field (all int, in this order).
struct AsppPlan {
  int dtype;      // 0 f32, 1 bf16
  int n;
  int h;
  int w;
  int c;
  int num_rates;
  int rate0;
  int rate1;
  int rate2;
  int rate3;
  int fuse;       // scale/bias given: BN fold + ReLU
  int vec;        // channels a thread: 16 bytes (8 bf16, 4 f32) or 1
  int nv;         // vectors a block: G = nv * vec channels; a power of two
  int nv_log2;    // log2(nv)
  int groups;     // ceil(c / G)
  int band;       // output rows a block owns
  int bands;      // ceil(h / band)
  int segmented;  // 1: a band-high row segment a (rate, dy); 0: one row range
  int reach;      // the largest rate below h (0 if none)
  int slab_rows;  // rows of the shared input slab
  int threads;    // a block's threads, a multiple of 32 and of nv
  int smem_bytes; // dynamic shared memory a block
};

// bytes of the block's f32 weights, scale and bias (16-byte aligned), then
// of its input slab; what the plan's smem_bytes must equal
__host__ __device__ inline int aspp_param_bytes(const AsppPlan& p) {
  return (11 * p.num_rates * p.nv * p.vec * 4 + 15) / 16 * 16;
}
inline int aspp_smem_bytes(const AsppPlan& p) {
  const int elem = p.dtype == kBFloat16 ? 2 : 4;
  const long long slab = static_cast<long long>(p.slab_rows) * p.w * p.nv * p.vec * elem;
  return aspp_param_bytes(p) + static_cast<int>((slab + 15) / 16 * 16);
}

// V consecutive elements of T <-> V floats (16-byte accesses where V > 1)
template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<float, 8> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // RNE each
      words[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  }
};
template <typename T> struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&f)[1]) { f[0] = to_f32(*p); }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    *p = from_f32<T>(f[0]);
  }
};

__device__ __forceinline__ int plan_rate(const AsppPlan& p, int i) {
  return i == 0 ? p.rate0 : i == 1 ? p.rate1 : i == 2 ? p.rate2 : p.rate3;
}

// segmented slab: the row offset of segment s (0: the band itself; 1 + 2k and
// 2 + 2k: -r and +r of the k-th rate below h)
__device__ __forceinline__ int segment_offset(const AsppPlan& p, int s) {
  if (s == 0) return 0;
  int k = 0;
  for (int i = 0; i < p.num_rates; ++i) {
    const int r = plan_rate(p, i);
    if (r >= p.h) continue;
    if (s == 1 + 2 * k) return -r;
    if (s == 2 + 2 * k) return r;
    ++k;
  }
  return 0;
}

// 4-byte asynchronous copy global -> shared (for single channels)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// n / d and n % d for 0 <= n < 2^22 by a float reciprocal: the estimate is
// off by at most one there, and one correction step makes it exact. Cheaper
// than an integer division by a value the compiler does not know.
struct Divider {
  int d;
  float inv;
  __device__ __forceinline__ explicit Divider(int divisor)
      : d(divisor), inv(1.f / static_cast<float>(divisor)) {}
  __device__ __forceinline__ int operator()(int n, int& rem) const {
    int q = __float2int_rz(static_cast<float>(n) * inv);
    rem = n - q * d;
    if (rem >= d) { ++q; rem -= d; }
    if (rem < 0) { --q; rem += d; }
    return q;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(256, 4)
multirate_dw_kernel(const T* __restrict__ x,
                    const float* __restrict__ wts,    // (R,3,3,C)
                    const float* __restrict__ scale,  // (R,C) or null
                    const float* __restrict__ bias,   // (R,C) or null
                    T* __restrict__ out,              // (R,N,H,W,C)
                    const AsppPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.nv * V;
  float* w_s = reinterpret_cast<float*>(smem);  // (R, 9, G)
  float* sc_s = w_s + p.num_rates * 9 * G;      // (R, G)
  float* bi_s = sc_s + p.num_rates * G;         // (R, G)
  T* slab = reinterpret_cast<T*>(smem + aspp_param_bytes(p));  // (slab_rows, W, G)

  const int g = blockIdx.x % p.groups;
  const int rest = blockIdx.x / p.groups;
  const int img = rest / p.bands;
  const int y0 = (rest % p.bands) * p.band;
  const int rows = min(p.band, p.h - y0);   // output rows of this band
  const int c0 = g * G;                     // the group's first channel
  const int gc = min(G, p.c - c0);          // ... and its channel count
  const int lo = max(0, y0 - p.reach);      // one-range slab: its first row
  const int hi = min(p.h, y0 + rows + p.reach);
  const int tid = threadIdx.x;
  const int pitch = p.w * G;                // slab elements a row
  const int wc = p.w * p.c;                 // x elements an input row
  const int wnv = p.w * p.nv;               // (column, vector) items a row
  const Divider by_wnv(wnv);

  // 1. one round trip: the input slab (16 bytes a copy where V > 1), then the
  // group's weights, scale and bias; channels past gc are never read
  {
    const T* xi = x + static_cast<size_t>(img) * p.h * wc + c0;
    const int total = p.slab_rows * wnv;
    const Divider by_band(p.band);
    for (int q = tid; q < total; q += blockDim.x) {
      int rem;
      const int s = by_wnv(q, rem);
      const int col = rem >> p.nv_log2;
      const int v = rem & (p.nv - 1);
      int src;
      if (p.segmented) {
        int j;
        const int seg = by_band(s, j);
        src = j < rows ? y0 + j + segment_offset(p, seg) : -1;
      } else {
        src = lo + s < hi ? lo + s : -1;
      }
      if (src < 0 || src >= p.h || v * V >= gc) continue;
      const T* from = xi + src * wc + col * p.c + v * V;
      T* to = slab + s * pitch + col * G + v * V;
      if constexpr (V > 1) {
        cp_async16(smem_u32(to), from);
      } else {
        *to = *from;
      }
    }
    // rows of G floats: 9R of weights, then R of scale and R of bias; 16
    // bytes a copy where V > 1 (C, c0 and the pointers are then multiples of
    // 4 floats), 4 bytes where V = 1; G / 4 and G are powers of two
    constexpr int kPer = V > 1 ? 4 : 1;  // floats a copy
    const int per_row_log2 = p.nv_log2 + (V > 1 ? (V == 8 ? 1 : 0) : 0);  // log2(G / kPer)
    const int rows_f = p.num_rates * (p.fuse ? 11 : 9);
    for (int q = tid; q < rows_f << per_row_log2; q += blockDim.x) {
      const int row = q >> per_row_log2;
      const int ch = (q & ((1 << per_row_log2) - 1)) * kPer;
      if (ch >= gc) continue;
      const int rs = p.num_rates * 9;
      const float* from = row < rs ? wts + row * p.c
                        : row < rs + p.num_rates ? scale + (row - rs) * p.c
                                                 : bias + (row - rs - p.num_rates) * p.c;
      float* to = w_s + row * G + ch;  // sc_s and bi_s follow w_s
      if constexpr (V > 1) {
        cp_async16(smem_u32(to), from + c0 + ch);
      } else {
        cp_async4(smem_u32(to), from + c0 + ch);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  // 2. one task a thread and pass: (rate, row, column, vector), the rate
  // slowest, so that a warp's lanes share its rate and row
  const int per_rate = rows * wnv;
  const Divider by_rate(per_rate);
  const size_t plane = static_cast<size_t>(p.n) * p.h * wc;  // one rate's output
  T* o = out + static_cast<size_t>(img) * p.h * wc + c0;
  for (int t = tid; t < p.num_rates * per_rate; t += blockDim.x) {
    int rem, rem2;
    const int ri = by_rate(t, rem);
    const int yl = by_wnv(rem, rem2);
    const int col = rem2 >> p.nv_log2;
    const int v = rem2 & (p.nv - 1);
    if (v * V >= gc) continue;
    const int r = plan_rate(p, ri);
    const int y = y0 + yl;
    // slab row of output row y at dy: yl + base(dy)
    int seg_m = 0, seg_p = 0, off_m = 0, off_0 = 0, off_p = 0;
    if (p.segmented) {
      int k = 0;  // the rate's index among those below h (its segments)
      for (int j = 0; j < ri; ++j) k += plan_rate(p, j) < p.h;
      seg_m = (1 + 2 * k) * p.band;
      seg_p = (2 + 2 * k) * p.band;
    } else {
      off_0 = y0 - lo;
      off_m = off_0 - r;
      off_p = off_0 + r;
    }
    const int base[3] = {p.segmented ? seg_m : off_m, off_0, p.segmented ? seg_p : off_p};
    const float* wv = w_s + ri * 9 * G + v * V;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = y + (dy - 1) * r;
      if (yy < 0 || yy >= p.h) continue;  // uniform across the warp's row
      const T* srow = slab + (yl + base[dy]) * pitch + v * V;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = col + (dx - 1) * r;
        if (xx < 0 || xx >= p.w) continue;  // SAME zero padding
        float xv[V], wk[V];
        Vec<T, V>::load(srow + xx * G, xv);
        Vec<float, V>::load(wv + (dy * 3 + dx) * G, wk);  // the same address across lanes
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(xv[e], wk[e], acc[e]);
      }
    }
    if (p.fuse) {
      float sc[V], bi[V];
      Vec<float, V>::load(sc_s + ri * G + v * V, sc);
      Vec<float, V>::load(bi_s + ri * G + v * V, bi);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaxf(acc[e] * sc[e] + bi[e], 0.f);
    }
    Vec<T, V>::store(o + ri * plane + y * wc + col * p.c + v * V, acc);
  }
}

template <typename T, int V>
int launch_multirate(const void* x, const float* k, const float* sc, const float* bi, void* out,
                     const AsppPlan& p, cudaStream_t s) {
  auto kernel = multirate_dw_kernel<T, V>;
  cudaError_t err = allow_smem(kernel, p.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p.n * p.bands * p.groups;
  kernel<<<blocks, p.threads, p.smem_bytes, s>>>(static_cast<const T*>(x), k, sc, bi,
                                                  static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dlk

// Launches on `stream` (of the current device) and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a plan
// this source does not make (ops/kernels/aspp.py builds it). x/out are f32
// or bf16 (plan->dtype); kernels, scale and bias f32.
extern "C" int multirate_atrous_depthwise(const void* x, const void* kernels, const void* scale,
                                          const void* bias, void* out,
                                          const dlk::AsppPlan* plan, void* stream) {
  const dlk::AsppPlan& p = *plan;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (p.num_rates < 1 || p.num_rates > dlk::kMaxRates) return bad;
  if (p.n * p.h * p.w == 0 || p.c == 0) return 0;
  if (p.nv < 1 || (1 << p.nv_log2) != p.nv || p.threads % 32 || p.threads > 256 ||
      p.smem_bytes != dlk::aspp_smem_bytes(p))
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(kernels);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (p.dtype == dlk::kFloat32 && p.vec == 4)
    return dlk::launch_multirate<float, 4>(x, k, sc, bi, out, p, s);
  if (p.dtype == dlk::kFloat32 && p.vec == 1)
    return dlk::launch_multirate<float, 1>(x, k, sc, bi, out, p, s);
  if (p.dtype == dlk::kBFloat16 && p.vec == 8)
    return dlk::launch_multirate<__nv_bfloat16, 8>(x, k, sc, bi, out, p, s);
  if (p.dtype == dlk::kBFloat16 && p.vec == 1)
    return dlk::launch_multirate<__nv_bfloat16, 1>(x, k, sc, bi, out, p, s);
  return bad;
}
