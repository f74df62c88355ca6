"""TFLite's integer arithmetic (tensorflow/lite/kernels/internal/common.h,
quantization_util.cc and gemmlowp's fixedpoint.h), as its reference kernels
compute it, on int64 torch tensors: the int8 builtins of
`export/tflite/interp.py` requantize with it, and `export/tflite/quantize.py`
writes the scales it reads.

- `quantize_multiplier`: a positive real multiplier as a Q31 significand and
  a power-of-two exponent (`QuantizeMultiplier`: `frexp`, the significand
  times 2^31 rounded half away from zero, 2^31 carried into the exponent,
  below 2^-31 flushed to 0).
- `multiply_by_quantized_multiplier`: x times that multiplier
  (`MultiplyByQuantizedMultiplier`): a left shift for a positive exponent,
  `SaturatingRoundingDoublingHighMul`, then `RoundingDivideByPOT` for a
  negative one. The high half rounds to nearest with ties up (toward +inf:
  its nudge is 2^30 for a product >= 0 and 1 - 2^30 below, then a division
  that truncates); the division by a power of two rounds ties away from zero
  (its threshold is one more for a negative x). `Requantizer` is the same
  product by fixed multipliers, its constants made once on the device: the
  int8 builtins requantize with it.
- `round_half_away`: `TfLiteRound` (`std::round`), which `torch.round` is
  not: it rounds ties to even.
- `quantize` / `dequantize`: `AffineQuantize` (the f32 value over the f32
  scale, rounded, plus the zero point, clamped) and its inverse.
- `activation_range`: the clamp of a fused activation in the quantized
  domain (`CalculateActivationRangeQuantized`).

Every sum that feeds these is exact: the int8 convolutions and matmuls
accumulate in float64 (below 2^53 every integer is exact) or int64, never in
float32, which loses integers past 2^24 (a 1x1 conv over 2048 channels
reaches ~2.8e8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

INT8_MIN, INT8_MAX = -128, 127
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _round_half_away_scalar(v: float) -> float:
    return math.copysign(math.floor(abs(v) + 0.5), v)


def quantize_multiplier(real) -> tuple[np.ndarray, np.ndarray]:
    """(significands, exponents) of one or many positive reals, int64 arrays
    of the input's shape: real ~= significand * 2^(exponent - 31)."""
    reals = np.asarray(real, np.float64)
    sig = np.zeros(reals.shape, np.int64)
    exp = np.zeros(reals.shape, np.int64)
    for i, r in np.ndenumerate(reals):
        if r == 0.0:
            continue
        if not r > 0.0 or not math.isfinite(r):
            raise ValueError(f"quantize_multiplier: {r} is no positive finite multiplier")
        q, shift = math.frexp(float(r))
        fixed = int(_round_half_away_scalar(q * (1 << 31)))
        if fixed == 1 << 31:
            fixed //= 2
            shift += 1
        if shift < -31:
            shift, fixed = 0, 0
        if shift > 30:
            shift, fixed = 30, INT32_MAX
        sig[i], exp[i] = fixed, shift
    return sig, exp


def quantize_multiplier_smaller_than_one(real) -> tuple[np.ndarray, np.ndarray]:
    """`QuantizeMultiplierSmallerThanOneExp`: as `quantize_multiplier`, for
    multipliers in (0, 1), whose exponents are <= 0 (a product by them is
    `MultiplyByQuantizedMultiplierSmallerThanOneExp`: no left shift)."""
    reals = np.asarray(real, np.float64)
    if np.any(reals <= 0) or np.any(reals >= 1):
        raise ValueError(f"a multiplier in (0, 1), not {reals}")
    return quantize_multiplier(reals)


def _high_mul(a: torch.Tensor, b) -> torch.Tensor:
    """The high half of 2ab, rounded to nearest with ties up (its nudge is
    2^30 for a product >= 0, 1 - 2^30 below, then a truncating division)."""
    ab = a * b
    return torch.div(ab + torch.where(ab >= 0, 1 << 30, 1 - (1 << 30)), 1 << 31,
                     rounding_mode="trunc")


def saturating_rounding_doubling_high_mul(a: torch.Tensor, b) -> torch.Tensor:
    """gemmlowp's `SaturatingRoundingDoublingHighMul` on int64 tensors:
    INT32_MIN * INT32_MIN saturates to INT32_MAX."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    return torch.where((a == INT32_MIN) & (b == INT32_MIN), INT32_MAX, _high_mul(a, b))


def _divide_by_pot(x: torch.Tensor, exponent, mask, half) -> torch.Tensor:
    """x / 2^exponent, ties away from zero: the threshold on the remainder
    (x & mask) is half the mask, one more for a negative x."""
    return (x >> exponent) + ((x & mask) > half + (x < 0)).to(torch.int64)


def rounding_divide_by_pot(x: torch.Tensor, exponent) -> torch.Tensor:
    """gemmlowp's `RoundingDivideByPOT`: x / 2^exponent (exponent >= 0)
    rounded to nearest, ties away from zero."""
    exponent = torch.as_tensor(exponent, dtype=torch.int64, device=x.device)
    mask = (1 << exponent) - 1
    return _divide_by_pot(x, exponent, mask, mask >> 1)


class Requantizer:
    """x -> `MultiplyByQuantizedMultiplier(x, multiplier, shift)` for fixed
    multipliers and shifts (one for all, or one per channel laid out in
    `shape`, which must broadcast against x): a left shift for a positive
    shift, the high mul, a rounding right shift for a negative one. Their
    powers of two and masks are made once, on `device`. A multiplier is in
    [0, 2^31), as `quantize_multiplier` makes it, so the high mul never
    saturates."""

    def __init__(self, multiplier, shift, device, shape=None):
        multiplier, shift = np.broadcast_arrays(np.asarray(multiplier, np.int64),
                                                np.asarray(shift, np.int64))
        if (multiplier < 0).any() or (multiplier > INT32_MAX).any():
            raise ValueError(f"a Q31 multiplier in [0, 2^31), not {multiplier}")
        shape = multiplier.shape if shape is None else shape
        right = np.maximum(-shift, 0)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device).reshape(shape)

        self.multiplier, self.left = put(multiplier), put(np.left_shift(1, np.maximum(shift, 0)))
        self.right, self.mask = put(right), put(np.left_shift(1, right) - 1)
        self.half = self.mask >> 1

    @classmethod
    def of(cls, real, device, shape=None) -> "Requantizer":
        """The requantizer of positive real multipliers (`quantize_multiplier`)."""
        return cls(*quantize_multiplier(real), device, shape)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        high = _high_mul(x * self.left, self.multiplier)
        return _divide_by_pot(high, self.right, self.mask, self.half)


def multiply_by_quantized_multiplier(x: torch.Tensor, multiplier, shift) -> torch.Tensor:
    """`MultiplyByQuantizedMultiplier(x, multiplier, shift)` on int64 `x`,
    with a multiplier and shift for each element of a broadcast (one per
    output channel) or one for all."""
    to_np = (lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
    return Requantizer(to_np(multiplier), to_np(shift), x.device)(x)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """`TfLiteRound` of a float tensor, in float64 (exact for every f32)."""
    x = x.double()
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def quantize(x: torch.Tensor, scale: float, zero_point: int, qmin: int = INT8_MIN,
             qmax: int = INT8_MAX) -> torch.Tensor:
    """`AffineQuantize`: round(x / scale) + zero_point, clamped, as int64;
    the quotient in f32 as TFLite computes it. The scale is a tensor on x's
    device: CUDA divides by a CPU scalar as a product with its reciprocal,
    which rounds a quotient differently now and then."""
    divisor = torch.tensor(np.float32(scale), device=x.device)
    q = round_half_away(x.float() / divisor).to(torch.int64) + int(zero_point)
    return q.clamp(qmin, qmax)


def dequantize(q: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    """(q - zero_point) * scale in f32."""
    return (q.to(torch.int64) - int(zero_point)).float() * np.float32(scale)


def activation_range(activation: int, scale: float, zero_point: int) -> tuple[int, int]:
    """The quantized clamp of a fused activation (0 NONE, 1 RELU,
    2 RELU_N1_TO_1, 3 RELU6), each bound rounded from value / scale in f32."""
    def q(v: float) -> int:
        return int(zero_point) + int(_round_half_away_scalar(float(np.float32(v) /
                                                                  np.float32(scale))))

    if activation == 1:
        return max(INT8_MIN, q(0.0)), INT8_MAX
    if activation == 3:
        return max(INT8_MIN, q(0.0)), min(INT8_MAX, q(6.0))
    if activation == 2:
        return max(INT8_MIN, q(-1.0)), min(INT8_MAX, q(1.0))
    if activation == 0:
        return INT8_MIN, INT8_MAX
    raise NotImplementedError(f"a quantized fused activation {activation}")
