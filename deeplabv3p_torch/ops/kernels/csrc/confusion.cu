// Fused per-pixel argmax + confusion-matrix histogram.
//
// Replaces the Pallas TPU kernel deeplabv3p_tpu/ops/pallas/confusion.py:
// confusion_matrix_fused (body `_kernel`): for every pixel, the first-index
// argmax over its C logits joins the label into bin C*gt + pred of a C x C
// histogram; labels outside [0, C) (the ignore index 255, negatives) are
// dropped. The full-resolution argmax map never reaches device memory.
//
// Bound: bytes. Each logit is read once and compared once: at the eval
// path's (8,512,512,21) f32 logits + int32 labels that is 176 MB + 8 MB
// against 44 M compares, so the least time is the 55 us the 184 MB take at
// 3.35 TB/s (PERF.md has the measured times).
//
// Design. What the Pallas kernel does for the TPU's sake is not carried
// over: its TILE x BINS one-hot compare-and-sum (the TPU serialises
// scatter), the -inf padding of C to 128 lanes, and the single output block
// revisited on a sequential grid. Here:
// * a warp takes 32 consecutive pixels, i.e. 32*C consecutive logits, and
//   copies them coalesced into its own slice of shared memory (as f32; bf16
//   widens exactly), with the row stride C|1 so that the lanes' per-pixel
//   scans below hit 32 different banks;
// * each lane scans its pixel's C logits from class 0 as jnp.argmax does:
//   a strict `>`, so the lowest index wins a tie, and a NaN counts as the
//   largest value, so the first NaN wins (an all-NaN pixel predicts class
//   0): the bin is always inside the histogram;
// * the block keeps a C*C int32 histogram in shared memory. Lanes of a warp
//   that hit the same bin (large uniform regions are the rule in
//   segmentation) are merged with __match_any_sync, and one lane adds their
//   count with one shared-memory atomic;
// * blocks are persistent (as many as fit the card at once, a grid-stride
//   loop over the 32-pixel chunks) and flush their non-zero bins to the
//   global int64 matrix with integer atomics at the end. Integer adds
//   commute, so the result does not depend on the order: deterministic.
// A block counts fewer than 2^31 pixels (the wrapper refuses more in all),
// so its int32 bins cannot overflow; the global sum is 64-bit.

#include <algorithm>

#include "common.cuh"

namespace dlk {

constexpr int kLabelU8 = 0;
constexpr int kLabelI32 = 1;
constexpr int kLabelI64 = 2;
constexpr int kMaxDynamicSmem = 232448;  // 227 KB a block on sm_90

template <typename T, typename L>
__global__ void confusion_kernel(const L* __restrict__ labels,
                                 const T* __restrict__ logits,
                                 unsigned long long* __restrict__ out,  // (C, C), zeroed
                                 long long n, int c, int stride) {
  extern __shared__ int smem[];
  const int bins = c * c;
  int* hist = smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* stage = reinterpret_cast<float*>(smem + bins) + warp * (32 * stride);
  for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  // (pixel, class) of the lane's i-th element advance by 32 classes a step
  const int step_pix = 32 / c, step_cls = 32 % c;
  const long long chunks = (n + 31) / 32;
  for (long long chunk = static_cast<long long>(blockIdx.x) * warps + warp; chunk < chunks;
       chunk += static_cast<long long>(gridDim.x) * warps) {
    const long long pix0 = chunk * 32;
    const int npix = static_cast<int>(min(32LL, n - pix0));
    const int count = npix * c;
    const T* src = logits + pix0 * c;
    int pix = lane / c, cls = lane % c;
    for (int i = lane; i < count; i += 32) {
      stage[pix * stride + cls] = to_f32(src[i]);
      pix += step_pix;
      cls += step_cls;
      if (cls >= c) {
        cls -= c;
        ++pix;
      }
    }
    __syncwarp();
    int bin = -1;  // dropped: invalid label, or a lane past the last pixel
    if (lane < npix) {
      const float* row = stage + lane * stride;
      float best = row[0];
      int pred = 0;
      for (int k = 1; k < c; ++k) {
        const float v = row[k];
        // strict: the first index wins a tie; the first NaN beats any number
        if (v > best || (v != v && best == best)) {
          best = v;
          pred = k;
        }
      }
      const long long gt = static_cast<long long>(labels[pix0 + lane]);
      if (gt >= 0 && gt < c) bin = static_cast<int>(gt) * c + pred;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    __syncwarp();  // the slice is rewritten by the next chunk
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const int v = hist[i];
    if (v) atomicAdd(&out[i], static_cast<unsigned long long>(v));
  }
}

template <typename T, typename L>
int launch_confusion(const void* labels, const void* logits, void* out, long long n, int c,
                     cudaStream_t s) {
  auto kernel = confusion_kernel<T, L>;
  const int stride = c | 1;
  // the most warps a block (histogram + one 32-pixel slice a warp) has room for
  int threads = 256;
  size_t smem = 0;
  for (;; threads >>= 1) {
    smem = sizeof(int) * (static_cast<size_t>(c) * c + static_cast<size_t>(threads) * stride);
    if (smem <= kMaxDynamicSmem || threads == 32) break;
  }
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = threads / 32;
  const long long chunks = (n + 31) / 32;
  const long long wanted = (chunks + warps - 1) / warps;
  const int grid = static_cast<int>(std::min(wanted, static_cast<long long>(sms) * per_sm));
  kernel<<<grid, threads, smem, s>>>(static_cast<const L*>(labels), static_cast<const T*>(logits),
                                     static_cast<unsigned long long*>(out), n, c, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_labels(const void* labels, const void* logits, void* out, int label_dtype,
                    long long n, int c, cudaStream_t s) {
  switch (label_dtype) {
    case kLabelU8: return launch_confusion<T, uint8_t>(labels, logits, out, n, c, s);
    case kLabelI32: return launch_confusion<T, int32_t>(labels, logits, out, n, c, s);
    case kLabelI64: return launch_confusion<T, int64_t>(labels, logits, out, n, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dlk

// Adds the confusion counts of n pixels into `out`, a zeroed (C, C) int64
// matrix (rows: label, columns: argmax). logits (n, C) are f32 (dtype 0) or
// bf16 (dtype 1); labels (n,) are uint8 (0), int32 (1) or int64 (2).
// Launches on `stream` (of the current device) and returns
// cudaGetLastError() (0 on success).
extern "C" int confusion_matrix_fused(const void* labels, const void* logits, void* out,
                                      int label_dtype, int logits_dtype, long long n, int c,
                                      void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_dtype == dlk::kFloat32)
    return dlk::dispatch_labels<float>(labels, logits, out, label_dtype, n, c, s);
  if (logits_dtype == dlk::kBFloat16)
    return dlk::dispatch_labels<__nv_bfloat16>(labels, logits, out, label_dtype, n, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
