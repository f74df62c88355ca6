// Shared helpers for the hand-written kernels: dtype codes and the
// f32 <-> storage-type conversions (intrinsics only, so the sources build
// with or without the __CUDA_NO_BFLOAT16_CONVERSIONS__ family of flags).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace dlk {

// dtype codes passed from Python (deeplabv3p_torch/ops/kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's .to(bfloat16)
}

// Launch shape of the ASPP kernel: one thread per output element,
// a block covers kChanTile consecutive channels (threadIdx.x, so a warp reads
// 32 neighbouring channels of one pixel: coalesced) of kPixTile pixels
// (threadIdx.y). Grid x walks the pixels, grid y the channel tiles. Offsets
// are 32-bit: the Python wrappers refuse tensors of 2^31 elements or more.
constexpr int kChanTile = 32;
constexpr int kPixTile = 8;

inline dim3 grid_for(int pixels, int channels) {
  return dim3((pixels + kPixTile - 1) / kPixTile, (channels + kChanTile - 1) / kChanTile);
}

// Shared memory a block can use on sm_90 (227 KB); above 48 KB only as dynamic
// shared memory after the attribute is set.
constexpr size_t kMaxSmem = 232448;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dlk
