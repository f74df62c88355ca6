"""Build, load and count the hand-written CUDA kernels.

`ops/kernels/csrc/*.cu` are compiled with `nvcc` for sm_90a, one `nvcc -c`
a source and all of them at once, then linked into ONE shared library with
a plain C interface, at first use, into `<repo>/build/kernels/<hash>/`
(listed in .gitignore). The hash covers the sources and the flags, so an
edit rebuilds and an unchanged tree reuses the library. The library is
loaded with `ctypes`; nothing here includes PyTorch's headers, which keeps
the build to seconds.

Every kernel wrapper is registered with `launch_counter`: it carries a
plain integer `launches` that the wrapper increments where it launches its
kernel (CUDA tensors only), so a run can show the main path went through
the kernel.

`LIB` is the `deeplabv3p` operator namespace. The three kernels that run
inside a model's forward (`multirate_atrous_depthwise`,
`fused_decoder_frontend`, `fused_inverted_residual`) are defined in it, each
with a CPU implementation (the plain version), a CUDA one (the launch) and a
fake one (shapes and types only), so that `torch.export` keeps each as one
graph node. They are defined with `Library.define` / `impl` rather than the
`torch.library.custom_op` decorator, whose Python wrapper adds host time to
every call (PERF.md). The loss tail and the confusion kernel run outside any
model's forward and stay plain functions, as does training-mode BatchNorm
(`batchnorm.py`: an autograd function, which no export traces).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libdeeplabv3p_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LIB = torch.library.Library("deeplabv3p", "DEF")

_lib = None
build_info: dict = {}
_counted: list[Callable] = []


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from source at first use on a machine with the toolkit"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path. Records timing and ptxas output in
    `build_info`."""
    sources = _sources()
    out_dir = BUILD_ROOT / _digest(sources)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        # one compiler a source, all started together; each logs to a file
        jobs = []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            log = open(os.path.join(tmp, src.stem + ".log"), "w+")
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        ptxas, failed = "", []
        for cmd, _, log, proc in jobs:
            proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
            ptxas += text
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_lib, *(obj for _, obj, _, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent loader sees all or none
    seconds = time.perf_counter() - t0
    (out_dir / "ptxas.log").write_text(ptxas)
    build_info.update(
        path=str(lib_path), seconds=seconds, cached=False,
        command=" ".join([nvcc, *NVCC_FLAGS, "-c", "<each source>"]), ptxas=ptxas,
    )
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library, declaring
    every exported function's argument types."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        lib.multirate_atrous_depthwise.argtypes = [
            p, p, p, p, p,           # x, kernels, scale, bias, out
            p, p,                    # the plan (aspp.AsppPlan), stream
        ]
        lib.multirate_atrous_depthwise.restype = i
        lib.fused_decoder_frontend.argtypes = [
            p, p, p, p, p, p,        # x_enc, skip, dw_kernel, scale, bias, out
            i, i, i, i, i, i, i, i,  # dtype, n, he, we, ce, hs, ws, cs
            f, f,                    # row / column source scale (in / out)
            i,                       # channels a thread (4 or 1)
            i, i, i,                 # a row block's row0, erow0, he_total
            p,                       # stream
        ]
        lib.fused_decoder_frontend.restype = i
        lib.fused_decoder_frontend_tile_rows.argtypes = [i, i]  # we, ws
        lib.fused_decoder_frontend_tile_rows.restype = i
        lib.fused_decoder_frontend_smem_bytes.argtypes = [i, i]  # we, ws
        lib.fused_decoder_frontend_smem_bytes.restype = ll
        lib.upsample_ce_forward.argtypes = [
            p, p, p,                 # logits, labels, wpx
            p, p, p, p,              # preds, lse, partial sums, loss
            i, i, i, i, i, i,        # b, h, w, c, H, W
            p,                       # stream
        ]
        lib.upsample_ce_forward.restype = i
        for fn in (lib.upsample_ce_forward_smem_bytes, lib.upsample_ce_forward_blocks):
            fn.argtypes = [i, i, i, i, i, i]  # b, h, w, c, H, W
            fn.restype = ll
        lib.upsample_ce_backward.argtypes = [
            p, p, p, p, p,           # logits, labels, wpx, lse, d_logits
            i, i, i, i, i, i,        # b, h, w, c, H, W
            p,                       # stream
        ]
        lib.upsample_ce_backward.restype = i
        lib.upsample_ce_backward_smem_bytes.argtypes = [i, i, i]  # w, c, W
        lib.upsample_ce_backward_smem_bytes.restype = ll
        lib.confusion_matrix_fused.argtypes = [
            p, p, p,                 # labels, logits, out (C,C) int64, zeroed
            i, i, ll, i,             # label dtype, logits dtype, pixels, classes
            p,                       # stream
        ]
        lib.confusion_matrix_fused.restype = i
        lib.fused_inverted_residual.argtypes = [
            p, p, p,                 # x, prepared weights (mbconv.py), out
            i, i, i, i, i, i, i,     # dtype, n, h, w, cin, cexp, cout
            i, i,                    # rate, residual
            i, i, i,                 # chunk, stages, shared-memory bytes
            p,                       # stream
        ]
        lib.fused_inverted_residual.restype = i
        lib.fused_inverted_residual_blocks_per_sm.argtypes = [i, i, i]  # dtype, cout, smem bytes
        lib.fused_inverted_residual_blocks_per_sm.restype = i
        d = ctypes.c_double
        bn_plan = [i, i, ll, i, i, i, i, i, i]  # dtype, vec, rows, channels, the plan (batchnorm.py)
        lib.bn_forward.argtypes = [
            p, p, p, p,              # x, y, partials, sums
            p, p, p, p, p,           # weight, bias, saved, running mean / var
            d, d, i, i,              # eps, momentum, update, phase
            *bn_plan, p,
        ]
        lib.bn_backward.argtypes = [
            p, p, p, p, p, p,        # dy, x, dx, partials, sums, total
            p, p, i,                 # saved, weight, phase
            *bn_plan, p,
        ]
        lib.bn_forward.restype = lib.bn_backward.restype = i
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a launch function returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t={status}")


def launch_counter(fn: Callable) -> Callable:
    """Give a kernel wrapper its launch count (a plain int attribute)."""
    fn.launches = 0
    _counted.append(fn)
    return fn


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _counted}


def reset_launch_counts() -> None:
    for fn in _counted:
        fn.launches = 0
