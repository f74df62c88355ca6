"""Fused MobileNetV2 inverted residual (stride 1, inference).

Counterpart of deeplabv3p_tpu/ops/pallas/mbconv.py. One call computes

    e = bf16(relu6((x @ we) * se + be))                    expand 1x1 + BN
    d = bf16(relu6(dw3x3(e, wd, dilation=rate) * sd + bd))  depthwise + BN
    y = (d @ wp) * sp + bp  (+ x)                           project 1x1 + BN

with the 6x-expanded tensors e and d kept out of device memory. The CUDA
kernel is `csrc/mbconv.cu` (both 1x1 products are computed in its body, on
the tensor cores); `fused_inverted_residual_reference` is its plain PyTorch
version, after the JAX package's lax oracle. The depthwise conv's SAME
padding is zero in E-space (after BN + relu6); e and d round to bf16
whatever x's type, the BN folds and the residual add are f32, the result
has x's type.

The weights stay f32-exact on the tensor cores: each of `we` and `wp` is
split once into a bf16 high and a bf16 low part (`split_bf16`), and the
kernel runs one product for each part on the same activations.
`prepare_inverted_residual` lays the parts out as the kernel's loads want
them, one contiguous block of bytes for each chunk of expanded channels;
a caller that runs the same block many times (`InvertedResBlock`) prepares
once and passes the result as `prepared=`.

Layout at this interface is the JAX one, NHWC; the model's channels_last
NCHW tensors permute to it for free.

The wrapper calls the operator `deeplabv3p::fused_inverted_residual`
(`_build.LIB`), so that `torch.export` keeps the kernel as one graph node. A
`PreparedBlock` is a Python object, which an operator's schema cannot
carry: the operator takes its blob and the ints of its configuration
(chunk, stages, shared-memory bytes) beside the nine tensors. Its CPU
implementation is the plain version on the nine tensors; its CUDA one
launches on the blob (or prepares one, when none is given); its fake one
gives the output's shape and type.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from deeplabv3p_torch.ops.kernels._build import LIB, check, launch_counter, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COUT = 320            # 10 tiles of 8 output channels a warp (csrc/mbconv.cu)
MAX_SHARED_BYTES = 232448  # 227 KB a block on sm_90
TILE = 8                  # output tile side of a block
EXPAND_FOLD_ROWS = 2      # f32 rows of a chunk's expand part: se, be
PROJECT_FOLD_ROWS = 11    # ... of its project part: the 9 depthwise taps, sd, bd
_WARP_TILES = (1, 2, 3, 5, 10)  # project tiles of 8 channels a warp the kernel is built for


def fused_inverted_residual_reference(
    x, we, se, be, wd, sd, bd, wp, sp, bp, *, rate: int = 1, residual: bool = False
) -> torch.Tensor:
    """Plain version: three f32 products with the two bf16 roundings of the
    kernel (e after expand + BN + relu6, d after depthwise + BN + relu6)."""
    cexp = we.shape[1]
    xf = x.float()
    e = torch.clamp(torch.matmul(xf, we.float()) * se + be, 0.0, 6.0).to(torch.bfloat16)
    k = wd.float().permute(2, 0, 1).unsqueeze(1)  # (Cexp,1,3,3)
    d = F.conv2d(e.float().permute(0, 3, 1, 2), k, padding=rate, dilation=rate, groups=cexp)
    d = torch.clamp(d.permute(0, 2, 3, 1) * sd + bd, 0.0, 6.0).to(torch.bfloat16)
    y = torch.matmul(d.float(), wp.float()) * sp + bp
    if residual:
        y = y + xf
    return y.to(x.dtype)


def split_bf16(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both bf16, with hi + lo equal to the f32 `w` to 2^-16
    relative: hi = bf16(w), lo = bf16(w - hi)."""
    w = w.float()
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


@dataclass(frozen=True)
class KernelConfig:
    """How one launch cuts its work, chosen so that a block's shared memory
    fits the card: `chunk` expanded channels a pass (32 or 16), `stages`
    buffers for the chunks' weights (2: the next chunk loads during this
    one's arithmetic; 1: it loads after it)."""
    chunk: int
    stages: int
    warp_tiles: int   # 8-channel project tiles a warp owns: Cout pads to 32 * warp_tiles
    kpad: int         # Cin padded to the tensor-core depth, 16
    smem_bytes: int

    @property
    def cout_pad(self) -> int:
        return 32 * self.warp_tiles

    @property
    def x_stride(self) -> int:
        """Bytes of one shared-memory row of K = kpad bf16 values: 16 bytes
        of padding make the row an odd number of 16-byte units, so the 8
        rows of a tensor-core load fall in 8 different bank groups."""
        return 2 * self.kpad + 16

    @property
    def e_stride(self) -> int:
        return 2 * self.chunk + 16

    @property
    def expand_bytes(self) -> int:
        """A chunk's expand part: we hi, we lo (chunk rows of K), then se and
        be (f32 rows of chunk)."""
        return 2 * self.chunk * self.x_stride + EXPAND_FOLD_ROWS * self.chunk * 4

    @property
    def project_bytes(self) -> int:
        """... and its project part: wp hi, wp lo (cout_pad rows of chunk),
        then the 9 taps of wd, sd and bd (f32 rows of chunk). The kernel
        loads the two parts at different times."""
        return 2 * self.cout_pad * self.e_stride + PROJECT_FOLD_ROWS * self.chunk * 4

    @property
    def chunk_bytes(self) -> int:
        return self.expand_bytes + self.project_bytes

    def blob_bytes(self, cexp: int) -> int:
        """Bytes of a prepared blob for `cexp` expanded channels: the chunks,
        then sp and bp padded to `cout_pad` f32 each."""
        return -(-cexp // self.chunk) * self.chunk_bytes + 2 * self.cout_pad * 4


@functools.lru_cache(maxsize=None)
def kernel_config(cin: int, cout: int, rate: int, elem_size: int) -> KernelConfig:
    """The first of (32, 2), (32, 1), (16, 2), (16, 1) (chunk, stages) whose
    shared memory fits a block; raises ValueError if none does. An f32 x is
    staged as a bf16 high and a bf16 low part."""
    warp_tiles = next((t for t in _WARP_TILES if 32 * t >= cout), None)
    if warp_tiles is None:
        raise ValueError(f"fused_inverted_residual: Cout {cout} > {MAX_COUT}")
    kpad = (cin + 15) // 16 * 16
    side = TILE + 2 * rate
    rows = (side * side + 15) // 16 * 16  # halo pixels, padded to the 16-row tiles
    parts = 2 if elem_size == 4 else 1
    smem = 0
    for chunk, stages in ((32, 2), (32, 1), (16, 2), (16, 1)):
        cfg = KernelConfig(chunk, stages, warp_tiles, kpad, 0)
        smem = (parts * rows * cfg.x_stride + (rows + TILE * TILE) * cfg.e_stride
                + stages * cfg.chunk_bytes)
        if smem <= MAX_SHARED_BYTES:
            return KernelConfig(chunk, stages, warp_tiles, kpad, smem)
    raise ValueError(
        f"fused_inverted_residual: rate {rate} x Cin {cin} x Cout {cout} needs {smem} bytes "
        f"of shared memory a block at the smallest chunk, the card has {MAX_SHARED_BYTES}")


@dataclass(frozen=True)
class PreparedBlock:
    """A block's parameters as the kernel reads them. `blob` (uint8) holds
    `config.chunk_bytes` for each chunk of expanded channels, then sp and bp
    padded to `config.cout_pad` f32 each; `params` are the nine f32 tensors
    it was built from (the plain version's arguments)."""
    params: tuple
    blob: torch.Tensor
    config: KernelConfig
    cin: int
    cexp: int
    cout: int
    rate: int
    elem_size: int


def _bytes(t: torch.Tensor, rows: int) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(rows, -1)


def prepare_inverted_residual(we, se, be, wd, sd, bd, wp, sp, bp, *, rate: int,
                              elem_size: int) -> PreparedBlock:
    """Split and lay out one block's f32 parameters for `csrc/mbconv.cu`,
    for inputs of `elem_size` bytes an element (4: f32, 2: bf16). Padding
    (Cin to 16, Cexp to the chunk, Cout to 32 * warp_tiles) is zeros, so a
    padded row or column contributes exactly 0."""
    cin, cexp = we.shape
    cout = wp.shape[1]
    cfg = kernel_config(cin, cout, int(rate), elem_size)
    kc, dev = cfg.chunk, we.device
    nch = (cexp + kc - 1) // kc
    cexp_pad = nch * kc
    # expand weights, transposed: row = expanded channel, K = Cin contiguous
    we_t = torch.zeros((cexp_pad, cfg.x_stride // 2), dtype=torch.float32, device=dev)
    we_t[:cexp, :cin] = we.float().t()
    # project weights, transposed per chunk: row = output channel, K = chunk contiguous
    wp_pad = torch.zeros((cexp_pad, cfg.cout_pad), dtype=torch.float32, device=dev)
    wp_pad[:cexp, :cout] = wp.float()
    wp_t = F.pad(wp_pad.reshape(nch, kc, cfg.cout_pad).permute(0, 2, 1), (0, 8))

    def fold_rows(*vectors):  # (rows, Cexp) f32 -> a chunk's rows side by side
        rows = torch.zeros((len(vectors), cexp_pad), dtype=torch.float32, device=dev)
        for row, v in zip(rows, vectors):
            row[:cexp] = v.float()
        return rows.reshape(len(vectors), nch, kc).permute(1, 0, 2)

    chunks = torch.cat([*(_bytes(part, nch) for part in split_bf16(we_t)),
                        _bytes(fold_rows(se, be), nch),
                        *(_bytes(part, nch) for part in split_bf16(wp_t)),
                        _bytes(fold_rows(*wd.reshape(9, cexp), sd, bd), nch)], dim=1)
    assert chunks.shape == (nch, cfg.chunk_bytes)
    tail = torch.zeros((2, cfg.cout_pad), dtype=torch.float32, device=dev)
    tail[0, :cout], tail[1, :cout] = sp.float(), bp.float()
    blob = torch.cat([chunks.reshape(-1), _bytes(tail, 1).reshape(-1)])
    return PreparedBlock((we, se, be, wd, sd, bd, wp, sp, bp), blob, cfg, cin, cexp, cout,
                         int(rate), elem_size)


def _check_args(x, we, se, be, wd, sd, bd, wp, sp, bp, rate, residual) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (N,H,W,Cin), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    cin = x.shape[-1]
    if we.ndim != 2 or we.shape[0] != cin:
        raise ValueError(f"we must be ({cin}, Cexp), got {tuple(we.shape)}")
    cexp = we.shape[1]
    if wp.ndim != 2 or wp.shape[0] != cexp:
        raise ValueError(f"wp must be ({cexp}, Cout), got {tuple(wp.shape)}")
    cout = wp.shape[1]
    if tuple(wd.shape) != (3, 3, cexp):
        raise ValueError(f"wd must be {(3, 3, cexp)}, got {tuple(wd.shape)}")
    for name, t, c in (("se", se, cexp), ("be", be, cexp), ("sd", sd, cexp),
                       ("bd", bd, cexp), ("sp", sp, cout), ("bp", bp, cout)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    if int(rate) < 1:
        raise ValueError(f"rate must be >= 1, got {rate}")
    if residual and cin != cout:
        raise ValueError("residual requires Cin == Cout")


LIB.define("fused_inverted_residual(Tensor x, Tensor we, Tensor se, Tensor be, Tensor wd, "
           "Tensor sd, Tensor bd, Tensor wp, Tensor sp, Tensor bp, Tensor? blob, int rate, "
           "bool residual, int chunk, int stages, int smem_bytes) -> Tensor")


@torch.library.register_fake("deeplabv3p::fused_inverted_residual")
def _fake(x, we, se, be, wd, sd, bd, wp, sp, bp, blob, rate, residual, chunk, stages,
          smem_bytes):
    _check_args(x, we, se, be, wd, sd, bd, wp, sp, bp, rate, residual)
    return x.new_empty((*x.shape[:3], wp.shape[1]))


def _plain(x, we, se, be, wd, sd, bd, wp, sp, bp, blob, rate, residual, chunk, stages,
           smem_bytes):
    _check_args(x, we, se, be, wd, sd, bd, wp, sp, bp, rate, residual)
    return fused_inverted_residual_reference(x, we, se, be, wd, sd, bd, wp, sp, bp,
                                             rate=rate, residual=residual)


def _launch(x, we, se, be, wd, sd, bd, wp, sp, bp, blob, rate, residual, chunk, stages,
            smem_bytes):
    """The operator's CUDA implementation. Without a blob, the nine tensors
    are checked and prepared here; with one, its configuration must be the
    one `kernel_config` gives for this call and its size must match it."""
    if x.ndim != 4 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16 (N,H,W,Cin), got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_inverted_residual needs contiguous inputs")
    n, h, w, cin = x.shape
    if cin % 4 or x.data_ptr() % 16:
        raise ValueError("fused_inverted_residual: Cin must be a multiple of 4 and x "
                         "16-byte aligned (the input tile is staged 4 channels a load)")
    if n > 65535 or (h + TILE - 1) // TILE > 65535:
        raise ValueError("fused_inverted_residual: more than 65535 images or tile rows")
    params = (we, se, be, wd, sd, bd, wp, sp, bp)
    if blob is None:
        _check_args(x, *params, rate, residual)
        for t in params:
            if t.device != x.device or t.dtype != torch.float32:
                raise ValueError("the kernels and BN folds must be float32 on x's device")
            if not t.is_contiguous():
                raise ValueError("fused_inverted_residual needs contiguous inputs")
        if wp.shape[1] > MAX_COUT:
            raise ValueError(f"fused_inverted_residual: Cout {wp.shape[1]} > {MAX_COUT}")
        prepared = prepare_inverted_residual(*params, rate=rate, elem_size=x.element_size())
        blob, cfg = prepared.blob, prepared.config
    else:
        cfg = kernel_config(cin, wp.shape[1], int(rate), x.element_size())
        if ((chunk, stages, smem_bytes) != (cfg.chunk, cfg.stages, cfg.smem_bytes)
                or we.shape[0] != cin or blob.dtype != torch.uint8
                or blob.device != x.device or not blob.is_contiguous()
                or blob.numel() != cfg.blob_bytes(we.shape[1])):
            raise ValueError("fused_inverted_residual: the prepared blob was built for "
                             "another block, rate, input type or device")
    cexp, cout = we.shape[1], wp.shape[1]
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    args = (x.data_ptr(), blob.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], n, h, w, cin, cexp, cout, int(rate), int(bool(residual)),
            cfg.chunk, cfg.stages, cfg.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        status = lib.fused_inverted_residual(*args)
    else:
        with torch.cuda.device(x.device):
            status = lib.fused_inverted_residual(*args)
    check(status, "fused_inverted_residual")
    fused_inverted_residual.launches += 1
    return out


LIB.impl("fused_inverted_residual", _plain, "CPU")
LIB.impl("fused_inverted_residual", _launch, "CUDA")
_op = torch.ops.deeplabv3p.fused_inverted_residual.default


@launch_counter
def fused_inverted_residual(
    x: torch.Tensor,                     # (N, H, W, Cin)
    we: torch.Tensor,                    # (Cin, Cexp) expand kernel (1x1)
    se: torch.Tensor, be: torch.Tensor,  # (Cexp,) folded expand BN
    wd: torch.Tensor,                    # (3, 3, Cexp) depthwise kernel
    sd: torch.Tensor, bd: torch.Tensor,  # (Cexp,) folded depthwise BN
    wp: torch.Tensor,                    # (Cexp, Cout) project kernel (1x1)
    sp: torch.Tensor, bp: torch.Tensor,  # (Cout,) folded project BN
    *,
    rate: int = 1,
    residual: bool = False,
    prepared: Optional[PreparedBlock] = None,
) -> torch.Tensor:
    """One pass over a stride-1 MobileNetV2 inverted residual; returns
    (N, H, W, Cout) in x's dtype. x float32 or bfloat16, every other tensor
    float32. CPU tensors run the plain version; CUDA tensors launch
    csrc/mbconv.cu (contiguous inputs on x's device, Cin a multiple of 4,
    Cout <= 320, the staged tiles within the block's shared memory).
    `prepared` is `prepare_inverted_residual` of the same nine tensors,
    rate and x's element size (then the nine tensors are not checked
    again on the card); without it they are prepared on the fly."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")
    params = (we, se, be, wd, sd, bd, wp, sp, bp)
    if prepared is None:
        return _op(x, *params, None, int(rate), bool(residual), 0, 0, 0)
    if ((prepared.cin, prepared.rate, prepared.elem_size)
            != (x.shape[-1], int(rate), x.element_size()) or prepared.blob.device != x.device
            or (residual and prepared.cout != x.shape[-1])):
        raise ValueError("fused_inverted_residual: `prepared` was built for another block, "
                         "rate, input type or device")
    cfg = prepared.config
    return _op(x, *params, prepared.blob, int(rate), bool(residual), cfg.chunk, cfg.stages,
               cfg.smem_bytes)
