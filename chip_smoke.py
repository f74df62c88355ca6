#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeplabv3p_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one GPU
    python3 chip_smoke.py --aspp   # steps 1-2 and the ASPP kernel alone

1. prints the card (`nvidia-smi` name and power limit) and the versions;
2. builds the CUDA kernels from deeplabv3p_torch/ops/kernels/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at ragged ones, with TF32 off: the ASPP kernel in
   f32 and bf16 at the serving (b1) and eval (b8) shapes, OS8, OS32's rates,
   rates past the map, ragged channel counts and 4 rates, fused and bare,
   printing each plan (channels a thread, blocks, band, shared memory); the
   decoder kernel in f32 and bf16 at the serving shape, a
   ragged one with non-integer scales, batch 8, OS8's scale 2 and channel
   counts that are no multiple of 4, printing for each the channels a thread
   owns and the blocks and shared memory of its plan; the loss tail's forward
   and backward (csrc/upsample_ce.cu) at the training slice's (16,128,128,21)
   -> 512^2, the lite head's (2,32,32,21) -> 512^2 and a ragged (3,29,37,21)
   -> (116,148), each kernel also alone at scale 1 and at an odd scale and
   twice in a row for bit-equal results, the forward besides at 6 and 151
   classes, at scale 2 and at a width that is no multiple of 4, with its lse
   held against torch.logsumexp; the confusion kernel (csrc/confusion.cu,
   EQUAL) at the eval
   slice's (8,512,512,21) in f32 and bf16, a ragged (3,37,41,6) and C = 151;
   the inverted-residual kernel (csrc/mbconv.cu) at the 13 block shapes of
   the batch-8 512x512 OS16 body, the JAX tests' four, a ragged map and
   OS8's rate 4, bf16 and f32; torch.argmax (`mask_argmax`) on the card
   against numpy's argmax on logits with planted ties and NaNs;
4. the serving path: 8 requests through `DeepLab` (mobilenetv2, full ASPP +
   decoder head, 512x512, OS16, 21 VOC classes, bf16, seeded weights) as
   built by default (fused ASPP kernel), then 8 more with the fused decoder
   kernel too, checking that each kernel's launch count rose by one a
   request, and the masks and logits against the same weights in f32 with
   both kernels off;
5. the training path: `deeplabv3p_torch.train.main` on a seeded synthetic
   dataset (32 pairs of 512x512, 21 classes, 255 bands) written to build/,
   mobilenetv2 OS16 b16 bf16 `--fused_loss --no_augment`, a frozen-backbone
   stage of 2 steps and a fine-tuning stage of 2; the loss kernels must run
   once a step each and the ASPP and decoder kernels never, the frozen
   backbone must not move in stage 1 and must in stage 2, and the final
   .npz must serve a request through `DeepLab`;
6. the fused against the unfused train step on the same weights and batch
   (f64 and f32 activations with TF32 off, then bf16);
7. the evaluation path: `deeplabv3p_torch.eval.main` on the same synthetic
   set and a seeded .npz, mobilenetv2 OS16 b8 bf16, 4 batches, once as built
   by default and once with `--fused_mbconv`; the confusion and ASPP kernels
   must run once a batch, the inverted-residual kernel never and then 13
   times a batch; the matrix must equal the one `torch.argmax` + `bincount`
   give on the same logits and count every valid label pixel, and stay
   within stated bounds of the same weights with every kernel off (bf16 and
   f32);
8. the train CLI with its own defaults (no --model_type, no --no_augment:
   mobilenetv3large_lite, 512x512, OS16, b16, bf16, the 12-op stochastic
   augmentation on the card) for 2+2 steps on a seeded set whose every other
   pair is 720x1280 (the random crop can fire), then with --fused_loss (the
   loss kernels at a x16 upsample) and with --device_cache (orig_hw is the
   input shape); the augmentation on the card against its CPU run on the
   same parameters (labels equal, images within 1e-3);
9. mobilenetv3large and mobilenetv3small serving (bf16, b1) with the ASPP
   kernel at 160 and 96 channels and the decoder kernel, masks against the
   f32 model with no kernel; the eval CLI with its own default model, its
   matrix equal to torch.argmax + bincount;
10. (a) the learning proof: the train CLI on the toy set of data/toy.py
   with bench.py's `learn` recipe (mobilenetv2, 256x256, b8, adam 1e-3,
   cosine, adaptive weights, --no_augment, 2 + 118 epochs,
   --bn_recalibrate), the eval CLI on its output: mIoU >= 0.95, seconds to
   it; the same weights as a .ckpt give the same matrix; (b) on those
   weights, the masks of --fused_mbconv against the default's, each against
   the f32 model with no kernel (>= 0.98), and each eval matrix (default and
   --fused_mbconv) equal to torch.argmax + bincount (the kernels at this
   eval's shapes are also held in steps 3-4);
11. (c) xception served (bf16, b1, the ASPP kernel at 2048 channels and the
   decoder kernel; masks against the f32 model with no kernel, >= 0.98) and
   evaluated at b8 through the eval CLI (the ASPP kernel at (8,32,32,2048));
   (d) the train CLI on xception b8 with --fused_loss and
   --optim_state_dtype bfloat16;
12. latency of the serving path, train-step time and peak memory fused and
   unfused in turns, images/s of the eval loop (default, `--fused_mbconv`,
   no kernels, in turns), the CLI default's step with the augmentation's
   share of it, xception's step unfused, fused and with bf16 optimizer
   state in turns (time, peak memory, the state's bytes), device-time
   profiles of one request, one train step and one eval batch, and each
   kernel's time against its plain version, its bound and, where there is
   one, the library's calls (the ASPP kernel's and the loss tail's rows also
   at the later slices' shapes, `at_other_shapes`; the decoder runs at the
   serving shapes on every path).

Exits non-zero on any failure, and without printing a result when there is
no CUDA device or no checkout around the script. The line before the last is
the kernels' JSON record; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--aspp` runs only steps 1-2 and the ASPP kernel's checks and times (bf16 b1
and b8, f32 b1), through the wrapper's public interface alone, so that the
script can also time the kernel of another checkout: copy it into that
checkout's root and run it there, in turns with this one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build")  # gitignored
N_REQUESTS = 8
INPUT = (512, 512)
# original (h, w) of the 8 requests: all differ from the model size and
# none is square, so mask_resize does real work
REQUEST_SHAPES = [(375, 500), (480, 640), (333, 517), (600, 400),
                  (512, 384), (281, 419), (720, 1280), (427, 640)]
WARMUP = 3
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_SEED = 32, 16, 0
# the CLI-defaults training set: every other pair at 720x1280, larger than the
# input on both axes, so the random crop can fire
V3_LARGE_HW, V3_SEED = (720, 1280), 5
V3_REQUESTS_SMALL = 4
EVAL_BATCH, EVAL_SEED = 8, 4
# the learning proof (bench.py:790-858): the toy set at 256x256, b8, 120 epochs
LEARN_HW, LEARN_BATCH, LEARN_EPOCHS, LEARN_TARGET = 256, 8, 120, 0.95
XCEPTION_BATCH = 8
# published peaks of one H100 SXM: device memory rate, f32 FMA rate outside
# the tensor cores, dense bf16 rate of the tensor cores (the inverted
# residual's two products; every other kernel multiplies by f32 weights in f32)
HBM_BYTES_PER_S, F32_FLOPS, BF16_TENSOR_FLOPS = 3.35e12, 67e12, 989e12
# (logits shape, logits dtype name, labels dtype name): the eval slice's call first
CONFUSION_CASES = [((8, 512, 512, 21), "float32", "int32"),
                   ((8, 512, 512, 21), "bfloat16", "uint8"),
                   ((3, 37, 41, 6), "float32", "int64"),
                   ((2, 50, 30, 151), "float32", "uint8"),
                   ((8, 256, 256, 4), "bfloat16", "int32")]  # the learning proof's eval
# (n, h, w, cin, cexp, cout, rate, residual) of tests/test_pallas_mbconv.py
MBCONV_TEST_CASES = [(2, 16, 16, 24, 144, 24, 1, True), (1, 16, 16, 64, 384, 96, 1, False),
                     (2, 8, 8, 32, 192, 32, 2, True), (1, 32, 16, 16, 96, 24, 1, False)]
# ... a map whose sides are no multiple of the 8x8 tile, and OS8's rate 4
MBCONV_EXTRA_CASES = [(3, 37, 29, 24, 144, 24, 1, True), (1, 64, 64, 160, 960, 160, 4, True)]
# (x shape, rates) ASPP cases: the serving path's (b1) and the eval path's (b8)
# calls, OS8, OS32's rates, a C that is no multiple of 8 with a rate past the
# map, a ragged map with rates past it, and 4 rates with C = 7
ASPP_CASES = [((1, 32, 32, 320), (6, 12, 18)), ((8, 32, 32, 320), (6, 12, 18)),
              ((1, 64, 64, 320), (12, 24, 36)), ((1, 16, 16, 320), (3, 6, 9)),
              ((1, 16, 16, 100), (6, 12, 18)), ((2, 37, 29, 136), (12, 24, 36)),
              ((3, 5, 4, 7), (3, 6, 9, 1)),
              ((1, 32, 32, 160), (6, 12, 18)), ((1, 32, 32, 96), (6, 12, 18)),
              ((1, 32, 32, 2048), (6, 12, 18)), ((8, 32, 32, 2048), (6, 12, 18)),
              ((8, 16, 16, 320), (6, 12, 18))]
# the serving calls of mobilenetv3large (160 channels) and mobilenetv3small (96),
# xception's serving (2048) and eval (b8) calls; the learning proof's eval
# call (256 px, OS16) is held but not timed
ASPP_SHAPE_CASES = {7: "aspp_c160", 8: "aspp_c96", 9: "aspp_c2048", 10: "aspp_c2048_b8"}
# (x_enc shape, skip shape) decoder cases: the serving path's, a ragged one with
# non-integer scales, the serving maps at batch 8, OS8's scale 2, and channel
# counts that are no multiple of 4 (one channel a thread)
DECODER_CASES = [((1, 32, 32, 256), (1, 128, 128, 48)), ((2, 13, 11, 200), (2, 50, 41, 48)),
                 ((8, 32, 32, 256), (8, 128, 128, 48)), ((1, 64, 64, 256), (1, 128, 128, 48)),
                 ((1, 16, 16, 100), (1, 64, 64, 46))]
# (B, h, w, C) -> (H, W) loss-tail cases; the first is the training slice's, the
# fourth mobilenetv3large_lite's --fused_loss call (OS16 logits, x16), the last
# xception's at b8
UPSAMPLE_CE_CASES = [((16, 128, 128, 21), (512, 512)), ((2, 32, 32, 21), (512, 512)),
                     ((3, 29, 37, 21), (116, 148)), ((16, 32, 32, 21), (512, 512)),
                     ((8, 128, 128, 21), (512, 512))]
# the backward kernel alone also at scale 1 and at an odd scale
UPSAMPLE_CE_BACKWARD_CASES = [((2, 24, 40, 21), (24, 40)), ((2, 24, 40, 21), (72, 120))]
# the forward kernel alone also there, at 6 and 151 classes (above 32 the batch-
# at-a-time kernel), at scale 2 and at a width that is no multiple of 32 or 4
UPSAMPLE_CE_FORWARD_CASES = UPSAMPLE_CE_BACKWARD_CASES + [
    ((2, 64, 64, 6), (256, 256)), ((1, 16, 24, 151), (64, 96)), ((2, 50, 30, 21), (100, 60)),
    ((2, 9, 7, 4), (27, 7))]

failures: list[str] = []


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


ZERO_LAUNCHES = {"multirate_atrous_depthwise": 0, "fused_decoder_frontend": 0,
                 "upsample_ce_forward": 0, "upsample_ce_backward": 0,
                 "confusion_matrix_fused": 0, "fused_inverted_residual": 0}


def run_cli(torch, kernels, cli_main, args, quiet: bool = True):
    """(result, wall s, launch counts, captured output) of one in-process CLI
    run, the counts set to 0 just before it and read just after; its prints
    captured when `quiet` (they are long), else shown."""
    import contextlib
    import io

    text = io.StringIO()
    kernels.reset_launch_counts()                    # the path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text) if quiet else contextlib.nullcontext():
        out = cli_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, kernels.launch_counts(), text.getvalue()  # ... and ends here


def tolerance(ref_max: float, dtype) -> float:
    """f32: 1e-5 * max|ref| + 1e-5 (summation order only). bf16: one
    rounding of the f32 sum, at most a bf16 ulp (2^-7 relative):
    2e-2 * max(1, max|ref|)."""
    import torch

    if dtype == torch.float32:
        return 1e-5 * ref_max + 1e-5
    return 2e-2 * max(1.0, ref_max)


def event_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(kernel_fn, plain_fn, iters: int = 200) -> tuple[float, float]:
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel, plain."""
    p1 = event_ms(plain_fn, iters)
    k1 = event_ms(kernel_fn, iters)
    k2 = event_ms(kernel_fn, iters)
    p2 = event_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, which of the two sets it): the bytes
    (each input read once, each output written once) over the memory rate,
    or the f32 operations over the f32 FMA rate, whichever is larger."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def aspp_case(torch, shape, rates, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    r, c = len(rates), shape[-1]
    x = torch.randn(shape, generator=gen).cuda().to(dtype)
    k = (torch.randn((r, 3, 3, c), generator=gen) / 3.0).cuda()
    scale = (0.5 + torch.rand((r, c), generator=gen)).cuda()
    bias = (0.1 * torch.randn((r, c), generator=gen)).cuda()
    return x, k, tuple(rates), scale, bias


def decoder_case(torch, enc_shape, skip_shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    c = enc_shape[-1] + skip_shape[-1]
    x = torch.randn(enc_shape, generator=gen).cuda().to(dtype)
    skip = torch.randn(skip_shape, generator=gen).relu().cuda().to(dtype)
    k = (torch.randn((3, 3, c), generator=gen) / 3.0).cuda()
    scale = (0.5 + torch.rand((c,), generator=gen)).cuda()
    bias = (0.1 * torch.randn((c,), generator=gen)).cuda()
    return x, skip, k, scale, bias


def max_err(got, want) -> tuple[float, float]:
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    ref = max(w.float().abs().max().item() for w in want)
    return err, ref


def aspp_plan_text(torch, kaspp, x, rates) -> str:
    """The wrapper's launch plan for x, where the checkout's wrapper has one."""
    if not hasattr(kaspp, "launch_plan"):
        return "no plan (an older wrapper)"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = kaspp.launch_plan(*x.shape, rates, x.dtype, True, x.data_ptr() % 16 == 0, sms)
    return (f"{p.vec} channel(s) a thread, {p.blocks} blocks of {p.threads} threads, bands of "
            f"{p.band} rows, {'segmented' if p.segmented else 'one-range'} slab of "
            f"{p.slab_rows} rows, {p.smem_bytes} B shared")


def aspp_checks(torch, kaspp) -> dict:
    """The ASPP kernel against its plain version at ASPP_CASES in f32 and
    bf16, fused (BN + ReLU) and, at the main path's two shapes, bare; a
    second call with the same signature (the wrapper's kept plan) gives the
    same bits. Returns the records the timing phase reuses: the serving
    path's bf16 b1 call, the eval path's bf16 b8 call and the f32 model's b1."""
    f32, bf16 = torch.float32, torch.bfloat16
    records = {}
    print("multirate_atrous_depthwise (csrc/aspp.cu) vs plain:")
    for i, (shape, rates) in enumerate(ASPP_CASES):
        for dtype in (f32, bf16):
            for fuse in (True, False) if i < 2 else (True,):
                x, k, r, s, b = aspp_case(torch, shape, rates, dtype, seed=1)
                s, b = (s, b) if fuse else (None, None)
                got = kaspp.multirate_atrous_depthwise(x, k, r, s, b)
                again = kaspp.multirate_atrous_depthwise(x, k, r, s, b)
                torch.cuda.synchronize()
                err, ref = max_err(got, kaspp.multirate_atrous_depthwise_reference(x, k, r, s, b))
                tol = tolerance(ref, dtype)
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                check(err <= tol and same and all(g.dtype == dtype for g in got),
                      f"aspp {shape} rates {rates} {dtype} {'bn_relu' if fuse else 'bare'}: "
                      f"max|err| {err:.3g} <= {tol:.3g} (max|ref| {ref:.3g}), two calls "
                      f"bit-equal: {same}; {aspp_plan_text(torch, kaspp, x, rates)}")
                key = {(0, bf16): "aspp", (1, bf16): "aspp_b8", (0, f32): "aspp_f32",
                       (9, f32): "aspp_c2048_f32",
                       **{(j, bf16): name for j, name in ASPP_SHAPE_CASES.items()}}.get(
                    (i, dtype))
                if key and fuse:
                    records[key] = {"max_abs_err": err, "case": (x, k, r, s, b)}
    return records


def aspp_timing(torch, kaspp, args, iters: int) -> dict:
    """One ASPP call's times: CUDA events around back-to-back calls of the
    wrapper (its host work included) and of the plain version, the
    profiler's device time a call, and the bound: x and the weights read
    once, one output a rate written once, or 9 multiply-adds and the BN fold
    an output at the f32 rate."""
    fn = kaspp.multirate_atrous_depthwise
    ref_fn = kaspp.multirate_atrous_depthwise_reference
    x, k = args[0], args[1]
    outs = len(args[2]) * x.numel()
    bound_ms, bound_by = bound(nbytes(x, k, *args[3:]) + outs * x.element_size(),
                               outs * (9 * 2 + 2))
    ms, plain_ms = ab_ms(lambda: fn(*args), lambda: ref_fn(*args), iters=iters)
    dev_us, dev_launches = device_us(torch, lambda: fn(*args))
    plain_us, plain_launches = device_us(torch, lambda: ref_fn(*args))
    print(f"multirate_atrous_depthwise {tuple(x.shape)} {x.dtype}: kernel {ms * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.2f} us a call (CUDA events, mean of 2x{iters} calls each); "
          f"device time a call (profiler): kernel {us_text(dev_us)} in {dev_launches} "
          f"launch(es), plain {us_text(plain_us)} in {plain_launches}; bound "
          f"{bound_ms * 1e3:.2f} us by {bound_by}  [{card_line()}]")
    return {"shape": list(x.shape), "dtype": str(x.dtype), "ms": ms, "plain_ms": plain_ms,
            "device_us": dev_us, "plain_device_us": plain_us, "bound_ms": bound_ms,
            "bound_by": bound_by}


def aspp_host_breakdown(torch, kaspp, args, calls: int = 2000) -> None:
    """Host time of one ASPP wrapper call and of its parts (host clock over
    `calls` back-to-back calls, the card synchronized after them): what
    CUDA events around back-to-back calls measure when the kernel is
    shorter than the host's work."""
    x, k, r, s, b = args
    out = torch.empty((len(r), *x.shape), dtype=x.dtype, device=x.device)
    parts = {"the wrapper": lambda: kaspp.multirate_atrous_depthwise(x, k, r, s, b),
             "torch.empty of the output": lambda: torch.empty(
                 (len(r), *x.shape), dtype=x.dtype, device=x.device),
             "out.unbind(0)": lambda: out.unbind(0),
             "torch.cuda.current_stream().cuda_stream":
                 lambda: torch.cuda.current_stream().cuda_stream,
             "torch.cuda.current_device()": torch.cuda.current_device,
             "four is_contiguous()": lambda: (x.is_contiguous(), k.is_contiguous(),
                                              s.is_contiguous(), b.is_contiguous()),
             "five data_ptr()": lambda: (x.data_ptr(), k.data_ptr(), s.data_ptr(),
                                         b.data_ptr(), out.data_ptr())}
    if hasattr(kaspp, "_signature"):
        parts["the signature key"] = lambda: kaspp._signature(x, k, r, s, b)
        lib, plan = kaspp.load_library(), kaspp._plans[kaspp._signature(x, k, r, s, b)][1]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), k.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), plan)
        parts["the library call alone (ctypes + launch)"] = (
            lambda: lib.multirate_atrous_depthwise(*ptrs, stream))
        parts["torch._C._cuda_getCurrentRawStream"] = (
            lambda: torch._C._cuda_getCurrentRawStream(x.device.index))
    text = []
    for name, fn in parts.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        text.append(f"{name} {(time.perf_counter() - t) / calls * 1e6:.2f}")
    print(f"  host us a call ({tuple(x.shape)} {x.dtype}, {calls} calls): " + ", ".join(text))


def aspp_plan_sweep(torch, kaspp, records) -> None:
    """Device time of the kernel at the b1 and b8 bf16 calls for other
    targets of blocks an SM (the plan's BLOCKS_PER_SM), the plans printed."""
    if not hasattr(kaspp, "BLOCKS_PER_SM"):
        return
    chosen = kaspp.BLOCKS_PER_SM
    for target in (1, 2, 4, 8, 16):
        kaspp.BLOCKS_PER_SM = target
        kaspp._plans.clear()
        for key in ("aspp", "aspp_b8"):
            args = records[key]["case"]
            dev, _ = device_us(torch, lambda: kaspp.multirate_atrous_depthwise(*args))
            print(f"  plan sweep, {target} blocks an SM aimed at, {tuple(args[0].shape)}: device "
                  f"{us_text(dev)}; {aspp_plan_text(torch, kaspp, args[0], args[2])}")
    kaspp.BLOCKS_PER_SM = chosen
    kaspp._plans.clear()


def aspp_times(torch, kaspp, records, launches) -> dict:
    """The ASPP kernel's kernels-JSON row: the serving path's bf16 b1 call,
    with the eval path's bf16 b8 call and the f32 model's b1 call beside it."""
    row = aspp_timing(torch, kaspp, records["aspp"]["case"], iters=200)
    b8 = aspp_timing(torch, kaspp, records["aspp_b8"]["case"], iters=100)
    f32_b1 = aspp_timing(torch, kaspp, records["aspp_f32"]["case"], iters=200)
    return {"name": "multirate_atrous_depthwise", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/aspp.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/aspp.py:85", "launches": launches,
            "max_abs_err": records["aspp"]["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "device_us": row["device_us"],
            "shape": row["shape"], "dtype": row["dtype"], "b8": b8, "f32_b1": f32_b1}


def make_requests(preprocess_image):
    """Seeded uint8 images at the original sizes, preprocessed as a user's
    request is (PIL bicubic resize + normalise), or, where PIL is missing,
    seeded arrays at the model size."""
    rng = np.random.default_rng(0)
    try:
        from PIL import Image
    except ImportError:
        print("  PIL missing: requests are seeded arrays at the model size")
        return [(rng.uniform(-1, 1, (1, *INPUT, 3)).astype(np.float32), hw)
                for hw in REQUEST_SHAPES]
    requests = []
    for h, w in REQUEST_SHAPES:
        # smooth random image: a coarse noise field, bilinearly enlarged
        coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        requests.append((preprocess_image(img, INPUT), (h, w)))
    return requests


def serve_requests(torch, deeplab, requests):
    """(masks, ms a request): each request through `predict`, host clock
    around it, synchronized."""
    masks, times = [], []
    for data, hw in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        masks.append(deeplab.predict(data, hw))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return masks, times


def main() -> None:
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        from deeplabv3p_torch.inference import DeepLab, preprocess_image
        from deeplabv3p_torch.ops import kernels
        from deeplabv3p_torch.ops.kernels import _build
        from deeplabv3p_torch.ops.kernels import aspp as kaspp
        from deeplabv3p_torch.ops.kernels import confusion as kconf
        from deeplabv3p_torch.ops.kernels import decoder as kdec
        from deeplabv3p_torch.ops.kernels import mbconv as kmb
        from deeplabv3p_torch.ops.kernels import upsample_ce as kce
        from deeplabv3p_torch.postprocess import mask_argmax
        from deeplabv3p_torch.train import main as train_main
        from deeplabv3p_torch.train import parse_args as train_args
    except ImportError as e:
        die(f"cannot import deeplabv3p_torch ({e}): run from a checkout of the repository")
    classes_path = os.path.join(REPO, "configs", "voc_classes.txt")
    if not os.path.exists(classes_path):
        die(f"{classes_path} missing: run from a checkout of the repository")

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device 0: {kind}, "
          f"{torch.cuda.device_count()} visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"plain side: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()  # builds, unless this source hash is built already
    info = _build.build_info
    print(f"built and loaded {info['path']} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s, cached={info['cached']}); "
          f"flags: {' '.join(_build.NVCC_FLAGS)}")
    for line in info.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    f32, bf16 = torch.float32, torch.bfloat16
    if "--aspp" in sys.argv[1:]:  # the ASPP kernel alone
        aspp_records = aspp_checks(torch, kaspp)
        row = aspp_times(torch, kaspp, aspp_records, None)
        for key in ("aspp", "aspp_b8"):
            aspp_host_breakdown(torch, kaspp, aspp_records[key]["case"])
        aspp_plan_sweep(torch, kaspp, aspp_records)
        print(json.dumps({"kernels": [row]}))
        if failures:
            die(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return
    records = {}

    # -- 3. ASPP kernel vs plain ---------------------------------------------
    records.update(aspp_checks(torch, kaspp))

    # -- 4. decoder kernel vs plain ------------------------------------------
    print("fused_decoder_frontend (csrc/decoder.cu) vs plain:")
    for enc, skip in DECODER_CASES:
        for dtype in (f32, bf16):
            args = decoder_case(torch, enc, skip, dtype, seed=2)
            got = kdec.fused_decoder_frontend(*args)
            torch.cuda.synchronize()
            err, ref = max_err(got, kdec.fused_decoder_reference(*args))
            tol = tolerance(ref, dtype)
            tile, smem = kdec.launch_plan(enc[2], skip[2])
            blocks = skip[0] * -(-skip[1] // tile) * -(-enc[3] // 32)
            check(err <= tol, f"decoder {enc}+{skip} {dtype}: max|err| {err:.3g} "
                              f"<= {tol:.3g} (max|ref| {ref:.3g}); "
                              f"{kdec.vector_width(enc[3], skip[3], *args[:3], got)} channel(s) a "
                              f"thread, {blocks} encoder blocks of {tile} rows, {smem} B shared")
            if enc == DECODER_CASES[0][0] and dtype == bf16:  # the serving path's call
                records["decoder"] = {"max_abs_err": err, "case": args}

    # -- 4b. loss-tail kernels vs plain ----------------------------------------
    print("upsample_ce_forward / upsample_ce_backward (csrc/upsample_ce.cu) vs plain:")
    for shape, out_hw in UPSAMPLE_CE_CASES:
        rec = upsample_ce_check(torch, kce, shape, out_hw)
        if shape == UPSAMPLE_CE_CASES[0][0]:  # the training path's call
            records["upsample_ce"] = rec
        if shape == UPSAMPLE_CE_CASES[3][0]:  # mobilenetv3large_lite --fused_loss
            records["upsample_ce_x16"] = rec
        if shape == UPSAMPLE_CE_CASES[4][0]:  # xception --fused_loss
            records["upsample_ce_b8"] = rec
    for shape, out_hw in UPSAMPLE_CE_BACKWARD_CASES:
        upsample_ce_backward_check(torch, kce, shape, out_hw)
    for shape, out_hw in UPSAMPLE_CE_FORWARD_CASES:
        upsample_ce_forward_check(torch, kce, shape, out_hw)

    # -- 4c. confusion and inverted-residual kernels vs plain ---------------------
    print("confusion_matrix_fused (csrc/confusion.cu) vs plain, EQUAL:")
    for i, case in enumerate(CONFUSION_CASES):
        rec = confusion_check(torch, kconf, *case)
        if i == 0:  # the eval path's call
            records["confusion"] = rec
    argmax_check(torch, kconf, mask_argmax)
    print("fused_inverted_residual (csrc/mbconv.cu) vs plain:")
    body_shapes = body_block_shapes(EVAL_BATCH, INPUT)
    check(len(body_shapes) == 13, f"the OS16 body has 13 stride-1 expanded blocks: "
                                  f"{[(s[1], s[3], s[4], s[5], s[6]) for s in body_shapes]}")
    records["mbconv"] = mbconv_checks(torch, kmb, body_shapes)
    learn_shapes = body_block_shapes(LEARN_BATCH, (LEARN_HW, LEARN_HW))
    print(f"  ... and at the learning proof's {len(learn_shapes)} body shapes (256 px, b8):")
    mbconv_checks(torch, kmb, learn_shapes, others=())

    # -- 5. the serving path ---------------------------------------------------
    common = dict(model_type="mobilenetv2", classes_path=classes_path,
                  model_input_shape=INPUT, output_stride=16, device="cuda")
    served = DeepLab(**common)                      # bf16, fused ASPP (the default)
    served_dec = DeepLab(fused_decoder=True, **common)
    requests = make_requests(preprocess_image)
    print(f"serving: DeepLab(mobilenetv2, {served.num_classes} classes, {INPUT}, OS16, "
          f"{served.dtype}), {N_REQUESTS} requests of original sizes {REQUEST_SHAPES}")
    for deeplab in (served, served_dec):
        for data, hw in requests[:WARMUP]:
            deeplab.predict(data, hw)
    torch.cuda.synchronize()

    def serve(deeplab):
        return serve_requests(torch, deeplab, requests)

    kernels.reset_launch_counts()                    # the main path starts here
    masks, times = serve(served)
    after_first = kernels.launch_counts()
    masks_dec, times_dec = serve(served_dec)
    launches = kernels.launch_counts()               # ... and ends here
    check(after_first == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": N_REQUESTS},
          f"default DeepLab: launch counts {after_first} (ASPP one a request, every other "
          "kernel none)")
    check(launches == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": 2 * N_REQUESTS,
                       "fused_decoder_frontend": N_REQUESTS},
          f"with fused_decoder=True: launch counts {launches}")
    for m, (_, hw) in zip(masks + masks_dec, requests + requests):
        if m.shape != hw or m.dtype != np.int32 or m.min() < 0 or m.max() >= served.num_classes:
            check(False, f"mask {m.shape} {m.dtype} [{m.min()}, {m.max()}] for a {hw} request")
            break
    else:
        check(True, "every mask has its request's original size and labels in [0, 21)")

    # -- reference: same weights, f32, both kernels off ------------------------
    plain = DeepLab(dtype=f32, fused_aspp=False, fused_decoder=False, **common)
    fused32 = DeepLab(dtype=f32, fused_aspp=True, fused_decoder=True, **common)
    same = all(torch.equal(a, b) for a, b in zip(served.model.state_dict().values(),
                                                 plain.model.state_dict().values()))
    check(same, "all DeepLabs hold the same seeded weights")

    def logits(deeplab, data):
        with torch.inference_mode():
            x = torch.from_numpy(data).cuda().permute(0, 3, 1, 2)
            return deeplab.model(x)

    stats = {"f32_fused": [], "bf16_served": [], "bf16_served_dec": []}
    mask_agree = {k: [] for k in stats}
    for i, (data, hw) in enumerate(requests):
        ref = logits(plain, data)
        ref_max = ref.abs().max().item()
        ref_mask = plain.predict(data, hw)
        for key, deeplab, mask in (("f32_fused", fused32, None),
                                   ("bf16_served", served, masks[i]),
                                   ("bf16_served_dec", served_dec, masks_dec[i])):
            out = logits(deeplab, data)
            if not torch.isfinite(out).all():
                check(False, f"{key}: non-finite logits on request {i}")
            stats[key].append(((out - ref).abs().max().item(), ref_max,
                               (mask_argmax(out, 1) == mask_argmax(ref, 1)).float().mean().item()))
            mask = deeplab.predict(data, hw) if mask is None else mask
            mask_agree[key].append(float((mask == ref_mask).mean()))
    for key, tol_rel, floor in (("f32_fused", 1e-3, 0.999),
                                ("bf16_served", 5e-2, 0.98),
                                ("bf16_served_dec", 5e-2, 0.98)):
        err = max(s[0] for s in stats[key])
        ref_max = max(s[1] for s in stats[key])
        agree = min(mask_agree[key])
        check(err <= tol_rel * ref_max,
              f"{key} vs f32 plain: max|dlogits| {err:.3g} <= {tol_rel:g} * max|logits| "
              f"({ref_max:.3g}); 512x512 argmax agreement min "
              f"{min(s[2] for s in stats[key]):.5f}")
        check(agree >= floor, f"{key} vs f32 plain: mask agreement at the original size, "
                              f"min over requests {agree:.5f} >= {floor}")

    # -- 5b. the training path, through its entry point ---------------------------
    train_launches, train_dir = training_path(torch, kernels, train_main, train_args,
                                              classes_path, requests[0])
    batch = train_batch(torch, train_dir, classes_path)
    fused_vs_unfused(torch, batch)

    # -- 5c. the evaluation path, through its entry point ---------------------------
    eval_launches, eval_state = evaluation_path(torch, kernels, classes_path, train_dir)

    # -- 5d. the train CLI with its own defaults (mobilenetv3large_lite, the
    # stochastic augmentation), then --fused_loss and --device_cache ---------------
    v3_launches, v3_root = default_training_path(torch, kernels, train_main, train_args,
                                                 classes_path)
    v3_batch = v3_train_batch(torch, v3_root)
    augment_card_vs_cpu(torch, v3_batch)

    # -- 5e. mobilenetv3 serving: the ASPP kernel at 160 and 96 channels ---------------
    v3_serve = more_serving(torch, kernels, classes_path, [
        ("mobilenetv3large", requests), ("mobilenetv3small", requests[:V3_REQUESTS_SMALL])])

    # -- 5f. the eval CLI with its own default model ----------------------------------
    default_evaluation_path(torch, kernels, classes_path, train_dir)

    # -- 5g. (a) the learning proof, (b) fused_mbconv on its trained weights ---------
    learn = learning_proof(torch, kernels, train_main, train_args)
    fused_mbconv_on_trained_weights(torch, learn)

    # -- 5h. (c) xception served (the ASPP kernel at 2048 channels, the decoder
    # kernel) and evaluated at b8 ------------------------------------------------------
    x_serve = more_serving(torch, kernels, classes_path, [("xception", requests)])
    x_eval_aspp = xception_evaluation_path(torch, kernels, classes_path, train_dir)

    # -- 5i. (d) xception trained, --fused_loss and bf16 optimizer state --------------
    x_train_launches = xception_training_path(torch, kernels, train_main, train_args,
                                              classes_path, train_dir)

    # -- 6. latency and kernel times ---------------------------------------------
    def pct(v, q):
        return float(np.percentile(v, q))

    print(f"latency of the counted run, {N_REQUESTS} requests each (host clock around "
          "predict, synchronized):")
    for name, ts in (("served (bf16, fused ASPP)", times), ("served + fused decoder", times_dec)):
        print(f"  {name}: median {statistics.median(ts):.3f} ms, p90 {pct(ts, 90):.3f} ms")
    served_plain = DeepLab(fused_aspp=False, **common)
    for data, hw in requests[:WARMUP]:
        served_plain.predict(data, hw)
    configs = {"bf16, no kernels": served_plain, "served (bf16, fused ASPP)": served,
               "served + fused decoder": served_dec}
    pooled = {name: [] for name in configs}
    for name in [*configs, *reversed(configs)]:  # in turns: P S D D S P
        pooled[name] += serve(configs[name])[1]
    print(f"latency A/B in turns (P S D D S P, {N_REQUESTS} requests a turn):")
    for name, ts in pooled.items():
        print(f"  {name}: median {statistics.median(ts):.3f} ms, p90 {pct(ts, 90):.3f} ms "
              f"over {len(ts)} requests")

    profile_one_request(torch, served, requests[0])

    train_step_numbers(torch, batch)
    eval_numbers(torch, eval_state)
    default_train_numbers(torch, v3_batch)
    xception_train_numbers(torch, train_dir, classes_path)

    kernels = [aspp_times(torch, kaspp, records, launches["multirate_atrous_depthwise"])]
    # the decoder: both inputs read once, the concat's depthwise output written
    # once; each upsampled element interpolated once (3 lerps) and 9 multiply-adds
    # + the BN fold an output
    args = records["decoder"]["case"]
    x, skip = args[0], args[1]
    pixels = skip.shape[0] * skip.shape[1] * skip.shape[2]
    outs = pixels * (x.shape[-1] + skip.shape[-1])
    bound_ms, bound_by = bound(nbytes(*args) + outs * x.element_size(),
                               pixels * x.shape[-1] * 6 + outs * (9 * 2 + 2))
    fn, ref_fn = kdec.fused_decoder_frontend, kdec.fused_decoder_reference
    ms, plain_ms = ab_ms(lambda: fn(*args), lambda: ref_fn(*args))
    dev_us, dev_launches = device_us(torch, lambda: fn(*args))
    plain_dev_us, plain_launches = device_us(torch, lambda: ref_fn(*args))
    print(f"fused_decoder_frontend: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a "
          f"call (CUDA events, mean of 2x200 calls each, serving-path shapes); device time a "
          f"call (profiler): kernel {us_text(dev_us)} in {dev_launches} launch(es), plain "
          f"{us_text(plain_dev_us)} in {plain_launches}")
    kernels.append({"name": "fused_decoder_frontend", "route": "cuda",
                    "source": "deeplabv3p_torch/ops/kernels/csrc/decoder.cu",
                    "replaces": "deeplabv3p_tpu/ops/pallas/decoder.py:81",
                    "launches": launches["fused_decoder_frontend"],
                    "max_abs_err": records["decoder"]["max_abs_err"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, "device_us": dev_us})
    kernels += upsample_ce_times(torch, kce, records["upsample_ce"], train_launches)
    kernels.append(confusion_times(torch, kconf, records["confusion"], eval_launches[0]))
    kernels.append(mbconv_times(torch, kmb, records["mbconv"], eval_launches[1], eval_state))
    # this slice's new shapes, each held and timed on its own path's run
    aspp_rows = [
        aspp_shape_row(torch, kaspp, records[key], served_more[model]["multirate_atrous_depthwise"],
                       f"{model} serving")
        for key, model, served_more in (("aspp_c160", "mobilenetv3large", v3_serve),
                                        ("aspp_c96", "mobilenetv3small", v3_serve),
                                        ("aspp_c2048", "xception", x_serve))]
    aspp_rows[-1]["f32_b1"] = aspp_timing(torch, kaspp, records["aspp_c2048_f32"]["case"], 200)
    aspp_rows.append(aspp_shape_row(torch, kaspp, records["aspp_c2048_b8"], x_eval_aspp,
                                    "xception eval b8"))
    kernels[0]["at_other_shapes"] = aspp_rows
    for key, launches_of, path in (("upsample_ce_x16", v3_launches,
                                    "mobilenetv3large_lite --fused_loss"),
                                   ("upsample_ce_b8", x_train_launches, "xception --fused_loss")):
        for row in upsample_ce_times(torch, kce, records[key], launches_of):
            row["path"] = path
            next(r for r in kernels if r["name"] == row["name"]).setdefault(
                "at_other_shapes", []).append(row)
    for row in kernels:
        for r in [row, *row.get("at_other_shapes", [])]:
            print(f"  {r['name']}{' (' + r['path'] + ')' if 'path' in r else ''}: "
                  f"{r['ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
                  f"by {r['bound_by']} ({r['bound_ms'] / r['ms']:.3f} of it), plain "
                  f"{r['plain_ms'] * 1e3:.2f} us, library "
                  f"{'none' if r['library_ms'] is None else format(r['library_ms'] * 1e3, '.2f') + ' us'}"
                  f", {r['launches']} launches on its path  [{card}]")

    leaked = [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]
    check(not leaked, f"no JAX module imported ({leaked or 'none'})")
    print(json.dumps({"kernels": kernels}))
    if failures:
        die(f"{len(failures)} check(s) failed: {failures}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def device_us(torch, fn, calls: int = 50) -> tuple[float | None, float]:
    """(device time in us, device launches) a call of fn(), from the
    profiler's CUDA kernel events: what the card spends, without the host's
    dispatch time that CUDA events around short calls also take in. Some
    runs' traces miss kernels: a launch count below the call's whole
    number of kernels shows it, and the time is then short by as much. A
    trace with no device time at all is taken once more; if that one is
    empty too the time is None: not measured (the CUDA-event time stands)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            return total / calls, sum(e.count for e in events) / calls
    return None, 0.0


def us_text(us: float | None, digits: int = 2) -> str:
    """A device time for print: 'not measured' where the trace gave none."""
    return "not measured" if us is None else f"{us:.{digits}f} us"


def profile_one_request(torch, deeplab, request) -> None:
    """Device time by kernel for one request (torch.profiler). The full
    table goes to build/profile_one_request.txt."""
    data, hw = request
    profile_one(torch, lambda: deeplab.predict(data, hw), "one served request",
                "profile_one_request.txt")


def profile_one(torch, fn, what: str, filename: str, top: int = 12) -> None:
    """Profile one fn() (after an unprofiled and a profiled warm-up window,
    since the first window pays the tracer's start-up): device operations,
    device busy time against the wall, idle share, the top rows by device
    time; the full table goes to build/<filename>."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()
    rows = sorted(((e.device_time_total, e.count, e.key) for e in events
                   if e.device_time_total > 0 and e.device_type.name == "CUDA"), reverse=True)
    if not rows:
        print(f"profile of {what}: torch.profiler recorded no device time")
        return
    busy_us = sum(r[0] for r in rows)
    print(f"profile of {what}: {sum(r[1] for r in rows)} device operations "
          f"(kernels and copies), device busy {busy_us:.1f} us of {wall_us:.1f} us wall "
          f"under the profiler (idle share {1 - busy_us / wall_us:.3f}); top by device time:")
    for total, count, key in rows[:top]:
        print(f"  {total:9.1f} us  {count:4d}x  {key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, filename), "w") as f:
        f.write(events.table(sort_by="device_time_total", row_limit=80))


# -- the loss tail and the training path -------------------------------------


def upsample_ce_case(torch, shape, out_hw, seed=0):
    """Seeded logits, labels with an ignore band and labels >= C, sample and
    class weights, on the card."""
    gen = torch.Generator().manual_seed(seed)
    b, _, _, c = shape
    logits = (2.0 * torch.randn(shape, generator=gen)).cuda()
    labels = torch.randint(0, c, (b, *out_hw), generator=gen, dtype=torch.int32)
    labels[:, : out_hw[0] // 8] = 255
    labels[0, -3:, : out_hw[1] // 2] = c
    labels[-1, -2:, out_hw[1] // 2:] = c + 7
    sw = (0.2 + 1.8 * torch.rand((b, *out_hw), generator=gen)).cuda()
    cw = (0.5 + 1.5 * torch.rand((c,), generator=gen)).cuda()
    return logits, labels.cuda(), sw, cw


def upsample_ce_check(torch, kce, shape, out_hw) -> dict:
    """Both loss-tail kernels, through the autograd Function, against the
    plain forward and backward: loss within 1e-5 relative, preds equal where
    the top-2 gap exceeds 1e-5, gradient within 1e-5 max|ref| + 1e-7."""
    logits, labels, sw, cw = upsample_ce_case(torch, shape, out_hw)
    z = logits.clone().requires_grad_(True)
    loss, preds = kce.fused_upsample_ce(z, labels, out_hw, sample_weights=sw, class_weights=cw)
    (loss * 0.37).backward()
    torch.cuda.synchronize()
    ref_loss, ref_preds = kce.upsample_ce_reference(logits, labels, out_hw, sw, cw)
    loss_err = abs(loss.item() - ref_loss.item())
    check(loss_err <= 1e-5 * abs(ref_loss.item()),
          f"upsample_ce {shape}->{out_hw} forward: loss {loss.item():.7g} vs plain "
          f"{ref_loss.item():.7g}, |err| {loss_err:.3g} <= 1e-5 relative")
    full = torch.nn.functional.interpolate(logits.permute(0, 3, 1, 2), size=out_hw,
                                           mode="bilinear", align_corners=False)
    top2 = full.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    same = torch.equal(preds[clear], ref_preds[clear])
    check(same, f"upsample_ce {shape}->{out_hw} forward: preds equal where the top-2 gap "
                f"> 1e-5 ({clear.float().mean().item():.6f} of pixels; all pixels equal: "
                f"{torch.equal(preds, ref_preds)})")
    wpx = kce.pixel_weights(labels, shape[-1], sw, cw)
    ref_grad = kce.upsample_ce_backward_reference(logits, labels, wpx, out_hw) * 0.37
    grad_err = (z.grad - ref_grad).abs().max().item()
    ref_max = ref_grad.abs().max().item()
    check(grad_err <= 1e-5 * ref_max + 1e-7,
          f"upsample_ce {shape}->{out_hw} backward: max|err| {grad_err:.3g} <= "
          f"1e-5 * {ref_max:.3g} + 1e-7")
    upsample_ce_forward_check(torch, kce, shape, out_hw, (logits, labels, wpx))
    lse = upsample_ce_backward_check(torch, kce, shape, out_hw, (logits, labels, wpx))
    return {"fwd_err": loss_err, "bwd_err": grad_err,
            "case": (logits, labels, wpx, tuple(out_hw), lse)}


def upsample_ce_forward_check(torch, kce, shape, out_hw, case=None) -> float:
    """The forward kernel by itself against the plain version: loss within
    1e-5 relative, preds equal where the top-2 gap exceeds 1e-5, lse within
    1e-5 max|plain| + 1e-6 of torch.logsumexp of the plain upsample (the
    kernel's exp2 and log2 are the approximate instructions, ~2 ulp), and two
    calls in a row bit-equal in loss, preds and lse (one partial sum a block,
    summed in a fixed order, no atomics). Returns the loss's error."""
    if case is None:
        logits, labels, sw, cw = upsample_ce_case(torch, shape, out_hw)
        case = (logits, labels, kce.pixel_weights(labels, shape[-1], sw, cw))
    logits, labels, wpx = case
    first = kce.upsample_ce_forward(logits, labels, wpx, out_hw)
    second = kce.upsample_ce_forward(logits, labels, wpx, out_hw)
    torch.cuda.synchronize()
    loss, preds, lse = first
    same_bits = all(torch.equal(a, b) for a, b in zip(first, second))
    ref_loss, ref_preds = kce.upsample_ce_reference(logits, labels, out_hw, sample_weights=wpx)
    loss_err = abs(loss.item() - ref_loss.item())
    full = kce._upsample(logits, out_hw)
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-5
    ref_lse = torch.logsumexp(full, dim=-1)
    lse_err, lse_max = (lse - ref_lse).abs().max().item(), ref_lse.abs().max().item()
    smem, blocks = kce.forward_plan(*shape, *out_hw)
    check(loss_err <= 1e-5 * abs(ref_loss.item()) and same_bits
          and torch.equal(preds[clear], ref_preds[clear]) and lse_err <= 1e-5 * lse_max + 1e-6,
          f"upsample_ce_forward {shape}->{tuple(out_hw)} alone: loss |err| {loss_err:.3g} <= 1e-5 "
          f"* {abs(ref_loss.item()):.6g}; preds equal where the top-2 gap > 1e-5 "
          f"({clear.float().mean().item():.6f} of pixels); lse max|err| {lse_err:.3g} <= 1e-5 * "
          f"{lse_max:.3g} + 1e-6; two calls bit-equal: {same_bits}; {blocks} blocks of {smem} B "
          "shared")
    return loss_err


def upsample_ce_backward_check(torch, kce, shape, out_hw, case=None):
    """The backward kernel by itself, from the forward kernel's lse: within
    1e-5 max|plain| + 1e-7 of the plain version (its sums run in another
    order, and its softmax is exp2 of log2(e)-scaled logits), and two calls
    in a row bit-equal (one owner thread a cell, a fixed order of summation,
    no atomics). Returns lse."""
    if case is None:
        logits, labels, sw, cw = upsample_ce_case(torch, shape, out_hw)
        case = (logits, labels, kce.pixel_weights(labels, shape[-1], sw, cw))
    logits, labels, wpx = case
    lse = kce.upsample_ce_forward(logits, labels, wpx, out_hw)[2]
    first = kce.upsample_ce_backward(logits, labels, wpx, lse, out_hw)
    second = kce.upsample_ce_backward(logits, labels, wpx, lse, out_hw)
    torch.cuda.synchronize()
    ref = kce.upsample_ce_backward_reference(logits, labels, wpx, out_hw)
    err, ref_max = (first - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 1e-5 * ref_max + 1e-7 and torch.equal(first, second),
          f"upsample_ce_backward {shape}->{tuple(out_hw)} alone: max|err| {err:.3g} <= "
          f"1e-5 * {ref_max:.3g} + 1e-7; two calls bit-equal: {torch.equal(first, second)}")
    return lse


def write_train_dataset(root: str, sizes, num_classes: int, seed: int) -> str:
    """Seeded pairs <root>/images/<id>.jpg + labels/<id>.png, one a (h, w) of
    `sizes`: smooth random images, labels of 64-px class cells with 4-px 255
    bands on their borders; returns the list file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    names = []
    for i, (h, w) in enumerate(sizes):
        band = (np.arange(h)[:, None] % 64 < 4) | (np.arange(w)[None, :] % 64 < 4)
        coarse = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3), dtype=np.uint8)
        Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
            os.path.join(root, "images", f"s{i:03d}.jpg"), quality=90)
        cells = rng.integers(0, num_classes, (h // 64 + 1, w // 64 + 1), dtype=np.uint8)
        label = np.kron(cells, np.ones((64, 64), np.uint8))[:h, :w]
        label[band] = 255
        Image.fromarray(label).save(os.path.join(root, "labels", f"s{i:03d}.png"))
        names.append(f"s{i:03d}")
    list_path = os.path.join(root, "list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def training_path(torch, kernels, train_main, train_args, classes_path, request):
    """`deeplabv3p_torch.train.main` in-process: two stages of 2 steps on the
    synthetic dataset. Returns the run's launch counts and the dataset dir."""
    import shutil

    from deeplabv3p_torch.inference import DeepLab
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    root = os.path.join(OUT_DIR, "smoke_train_data")
    log_dir = os.path.join(OUT_DIR, "smoke_train_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    list_path = write_train_dataset(root, [INPUT] * TRAIN_IMAGES, 21, TRAIN_SEED)
    print(f"training path: wrote {TRAIN_IMAGES} pairs of {INPUT} in "
          f"{time.perf_counter() - t0:.1f} s; python -m deeplabv3p_torch.train ...")
    argv = ["--model_type", "mobilenetv2", "--model_input_shape", "512x512",
            "--output_stride", "16", "--batch_size", str(TRAIN_BATCH), "--fused_loss",
            "--no_augment", "--transfer_epoch", "1", "--total_epoch", "2",
            "--freeze_level", "1", "--optimizer", "sgd", "--decay_type", "cosine",
            "--dataset_path", root, "--dataset_file", list_path,
            "--classes_path", classes_path, "--log_dir", log_dir,
            "--seed", str(TRAIN_SEED), "--device", "cuda"]
    print("  " + " ".join(argv))
    trainer, wall, launches, _ = run_cli(torch, kernels, train_main, train_args(argv),
                                         quiet=False)
    steps = 2 * (TRAIN_IMAGES // TRAIN_BATCH)
    print(f"  trained {steps} steps in {wall:.1f} s wall (set-up and first-call cuDNN "
          f"tuning included); launch counts {launches}")
    check(launches == {**ZERO_LAUNCHES, "upsample_ce_forward": steps,
                       "upsample_ce_backward": steps},
          f"training: each loss kernel launched once a step ({steps}), every other "
          "kernel never")
    with open(os.path.join(log_dir, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    check(len(records) == 2 and all(np.isfinite(r["loss"]) and r["steps"] == 2
                                    for r in records),
          f"history.jsonl: 2 records, 2 steps each, finite losses "
          f"{[round(r['loss'], 5) for r in records]}")
    check(trainer.history == records, "the trainer's history is what history.jsonl holds")

    init = build_deeplab_model("mobilenetv2", 21, device="cpu")
    init_parameters(init, torch.Generator().manual_seed(TRAIN_SEED), bn_identity=True)
    start = {k: v.clone() for k, v in init.state_dict().items()}
    model = build_deeplab_model("mobilenetv2", 21, device="cpu")

    def load(name):
        model.load_state_dict(from_jax_variables(load_npz(os.path.join(log_dir, name)), model))
        return {k: v.clone() for k, v in model.state_dict().items()}

    stage1 = load(next(p for p in sorted(os.listdir(log_dir)) if p.startswith("ep000-")))
    final = load("trained_final.npz")
    backbone = [k for k in start if k.startswith("backbone.")]
    bn_bufs = [k for k in backbone if "running_" in k]
    check(all(torch.equal(stage1[k], start[k]) for k in backbone),
          f"stage 1 (freeze level 1): the {len(backbone)} backbone tensors, its "
          f"{len(bn_bufs)} BN buffers included, are as initialised")
    head = [k for k in start if not k.startswith("backbone.")]
    # Three head BN scales reach a training-mode BN through per-channel ops only,
    # which normalises their scale away but for its epsilon: from this init their
    # gradients are 1e-6 to 1e-5 of the head's largest (tests/test_torch_train.py),
    # so two steps move them by a few ulps or not at all. Every other head weight
    # must move; theirs is printed.
    invariant = ("aspp.concat_projection_BN.weight", "decoder.feature_projection0_BN.weight",
                 "decoder.decoder_conv0.pointwise_BN.weight")
    unmoved = [k for k in head if k.endswith(".weight") and k not in invariant
               and torch.equal(stage1[k], start[k])]
    ulps = {k.split(".")[-2]: int(((stage1[k] - start[k]).abs()
                                   / (torch.finfo(torch.float32).eps * start[k].abs())).max())
            for k in invariant}
    check(not unmoved, f"stage 1 moved every head weight but the 3 nearly scale-invariant BN "
                       f"scales (unmoved: {unmoved or 'none'}; those 3 moved by at most "
                       f"{ulps} ulps)")
    convs = [k for k in backbone if k.endswith(".weight") and "_BN." not in k]
    moved = [k for k in convs + bn_bufs if not torch.equal(final[k], start[k])]
    check(len(moved) == len(convs + bn_bufs),
          f"stage 2 (freeze level 0) moved every backbone conv weight and BN buffer "
          f"({len(moved)}/{len(convs + bn_bufs)})")
    data, hw = request
    served = DeepLab(model_type="mobilenetv2", classes_path=classes_path,
                     model_input_shape=INPUT, output_stride=16, device="cuda",
                     weights_path=os.path.join(log_dir, "trained_final.npz"))
    mask = served.predict(data, hw)
    check(mask.shape == hw and mask.min() >= 0 and mask.max() < 21,
          f"trained_final.npz serves a request through DeepLab: mask {mask.shape} for {hw}")
    return launches, root


def default_training_path(torch, kernels, train_main, train_args, classes_path):
    """`python -m deeplabv3p_torch.train` with its own defaults (no
    --model_type, no --no_augment, no --fused_loss: mobilenetv3large_lite,
    512x512, OS16, b16, bf16, the stochastic augmentation), 2+2 steps on a
    seeded set whose every other pair is 720x1280; then the same with
    --fused_loss and with --device_cache. Returns the --fused_loss run's
    launch counts and the dataset dir."""
    import shutil

    from deeplabv3p_torch.data import augment
    from deeplabv3p_torch.inference import DeepLab

    root = os.path.join(OUT_DIR, "smoke_v3_train_data")
    sizes = [V3_LARGE_HW if i % 2 == 0 else INPUT for i in range(TRAIN_IMAGES)]
    t0 = time.perf_counter()
    list_path = write_train_dataset(root, sizes, 21, V3_SEED)
    print(f"training with the CLI's defaults: wrote {TRAIN_IMAGES} pairs, half {V3_LARGE_HW} "
          f"and half {INPUT}, in {time.perf_counter() - t0:.1f} s")
    seen = []
    real = augment.apply_augment

    def spy(params, images, labels, orig_hw, cfg=augment.AugmentConfig()):
        larger = (orig_hw[:, 0] > images.shape[1]) & (orig_hw[:, 1] > images.shape[2])
        seen.append((int(larger.sum()), int((params.crop & larger).sum())))
        return real(params, images, labels, orig_hw, cfg)

    augment.apply_augment = spy
    steps = 2 * (TRAIN_IMAGES // TRAIN_BATCH)
    fused_launches = None
    try:
        for extra in ((), ("--fused_loss",), ("--device_cache",)):
            log_dir = os.path.join(OUT_DIR, "smoke_v3_logs" + "".join(extra).replace("-", "_"))
            shutil.rmtree(log_dir, ignore_errors=True)
            argv = ["--dataset_path", root, "--dataset_file", list_path, "--classes_path",
                    classes_path, "--transfer_epoch", "1", "--total_epoch", "2",
                    "--log_dir", log_dir, *extra]
            args = train_args(argv)
            what = " ".join(extra) or "(defaults)"
            check((args.model_type, args.augment, args.batch_size, args.model_input_shape,
                   args.device) == ("mobilenetv3large_lite", True, 16, "512x512", "cuda"),
                  f"train CLI {what}: mobilenetv3large_lite, --augment, b16, 512x512, cuda "
                  "by default")
            print("  python -m deeplabv3p_torch.train " + " ".join(argv))
            seen.clear()
            trainer, wall, launches, _ = run_cli(torch, kernels, train_main, args, quiet=False)
            larger, cropped = sum(a for a, _ in seen), sum(b for _, b in seen)
            print(f"  {what}: {steps} steps in {wall:.1f} s wall (set-up, caching and first-call "
                  f"cuDNN tuning included); {len(seen)} augmented batches, {larger} samples "
                  f"larger than the input, the crop fired on {cropped}; launch counts {launches}")
            want = dict(ZERO_LAUNCHES)
            if "--fused_loss" in extra:
                want.update(upsample_ce_forward=steps, upsample_ce_backward=steps)
                fused_launches = launches
            check(launches == want, f"train CLI {what}: launch counts as the path runs them "
                                    f"(the loss kernels {want['upsample_ce_forward']} times "
                                    "each, every other kernel never)")
            check(len(seen) == steps, f"train CLI {what}: every batch augmented ({len(seen)})")
            if "--device_cache" in extra:
                check(larger == 0, "train CLI --device_cache: orig_hw is the input shape, "
                                   "the crop cannot fire")
            else:
                check(larger > 0, f"train CLI {what}: {larger} samples larger than the input "
                                  "reach the augmentation, the crop can fire")
            with open(os.path.join(log_dir, "history.jsonl")) as f:
                hist = [json.loads(line) for line in f]
            check(len(hist) == 2 and all(np.isfinite(r["loss"]) and r["steps"] == 2
                                         for r in hist) and trainer.history == hist,
                  f"train CLI {what}: history.jsonl has 2 records of 2 steps, finite losses "
                  f"{[round(r['loss'], 5) for r in hist]}")
    finally:
        augment.apply_augment = real
    served = DeepLab(model_type="mobilenetv3large_lite", classes_path=classes_path,
                     model_input_shape=INPUT, device="cuda",
                     weights_path=os.path.join(log_dir, "trained_final.npz"))
    data = np.random.default_rng(1).uniform(-1, 1, (1, *INPUT, 3)).astype(np.float32)
    mask = served.predict(data, (375, 500))
    check(mask.shape == (375, 500) and mask.min() >= 0 and mask.max() < 21,
          f"the last run's trained_final.npz loads strictly and serves: mask {mask.shape}")
    return fused_launches, root


def v3_train_batch(torch, root):
    """The first TRAIN_BATCH pairs of the CLI-defaults set as the loader
    gives them, on the card: (images u8, labels u8, orig_hw f32)."""
    from deeplabv3p_torch.data.pipeline import SegmentationDataset

    ids = [f"s{i:03d}" for i in range(TRAIN_BATCH)]
    ds = SegmentationDataset(root, ids, batch_size=TRAIN_BATCH, num_classes=21,
                             input_shape=INPUT, augment=False, shuffle=False)
    return tuple(torch.from_numpy(a).cuda() for a in next(iter(ds.epoch_batches())))


def augment_card_vs_cpu(torch, batch) -> None:
    """The chain on the card against its CPU run on one b16 batch, the
    parameters drawn once on the CPU with every gate at 0.5 (each op fires
    on some samples): labels EQUAL, images within 1e-3 on the 0..255 scale,
    then the weight maps equal."""
    from deeplabv3p_torch.data import augment

    images, labels, orig_hw = batch
    b, h, w = labels.shape
    cfg = augment.AugmentConfig(flip_prob=0.5, vflip_prob=0.5, zoom_rotate_prob=0.5,
                                gridmask_prob=0.5, grayscale_prob=0.5, blur_prob=0.5,
                                crop_prob=0.5)
    params = augment.draw_augment_params(torch.Generator().manual_seed(3), b, h, w, cfg)
    larger = (orig_hw[:, 0] > h) & (orig_hw[:, 1] > w)
    gates = {g: int(getattr(params, g).sum()) for g in (
        "hflip", "vflip", "zoom_rotate", "gridmask", "grayscale", "blur")}
    gates["crop"] = int((params.crop & larger.cpu()).sum())
    cpu_i, cpu_l = augment.apply_augment(params, images.cpu(), labels.cpu(), orig_hw.cpu(), cfg)
    card_i, card_l = augment.apply_augment(params.to("cuda"), images, labels, orig_hw, cfg)
    torch.cuda.synchronize()
    err = (card_i.cpu() - cpu_i).abs().max().item()
    diff = int((card_l.cpu() != cpu_l).sum())
    check(all(v > 0 for v in gates.values()),
          f"augmentation check: every gated op fires on some of the {b} samples {gates}")
    check(diff == 0 and err <= 1e-3,
          f"augmentation, card vs CPU on the same parameters ({b}x{h}x{w}): labels equal "
          f"({diff} differ), images max|err| {err:.3g} <= 1e-3 (0..255)")
    same_w = torch.equal(augment.adaptive_class_weights(card_l).cpu(),
                         augment.adaptive_class_weights(cpu_l))
    check(same_w, "augmentation, card vs CPU: the adaptive weight maps are equal")


def more_serving(torch, kernels, classes_path, runs) -> dict:
    """Each (model type, requests) of `runs` served (full head, bf16, b1)
    with the ASPP and decoder kernels: launch counts, masks against the same
    weights in f32 with no kernel (>= 0.98 of pixels), latency in turns with
    no kernel, and the profile of one mobilenetv3large or xception request.
    Returns each run's launch counts."""
    from deeplabv3p_torch.inference import DeepLab

    card = card_line()
    out = {}
    for model_type, reqs in runs:
        common = dict(model_type=model_type, classes_path=classes_path,
                      model_input_shape=INPUT, output_stride=16, device="cuda")
        served = DeepLab(fused_aspp=True, fused_decoder=True, **common)
        plain = DeepLab(dtype=torch.float32, fused_aspp=False, fused_decoder=False, **common)
        for data, hw in reqs[:WARMUP]:
            served.predict(data, hw)
        kernels.reset_launch_counts()                # this path starts here
        masks, times = serve_requests(torch, served, reqs)
        launches = kernels.launch_counts()           # ... and ends here
        n = len(reqs)
        check(launches == {**ZERO_LAUNCHES, "multirate_atrous_depthwise": n,
                           "fused_decoder_frontend": n},
              f"{model_type} serving: the ASPP kernel ({served.model.backbone.out_channels} "
              f"channels) and the decoder kernel once a request ({n}): {launches}")
        agree = min(float((m == plain.predict(data, hw)).mean())
                    for m, (data, hw) in zip(masks, reqs))
        shapes_ok = all(m.shape == hw and m.min() >= 0 and m.max() < 21
                        for m, (_, hw) in zip(masks, reqs))
        check(shapes_ok and agree >= 0.98,
              f"{model_type} serving, bf16 with both kernels vs f32 with none: masks of the "
              f"requests' sizes agree on >= 0.98 of pixels (min {agree:.5f})")
        configs = {"bf16, no kernels": DeepLab(fused_aspp=False, **common),
                   "bf16, ASPP + decoder kernels": served}
        for data, hw in reqs[:WARMUP]:
            configs["bf16, no kernels"].predict(data, hw)
        pooled = {name: [] for name in configs}
        for name in [*configs, *reversed(configs)]:  # in turns: P K K P
            pooled[name] += serve_requests(torch, configs[name], reqs)[1]
        print(f"  {model_type} latency in turns P K K P of {n} requests (host clock around "
              f"predict, synchronized)  [{card}]:")
        for name, ts in pooled.items():
            print(f"    {name}: median {statistics.median(ts):.3f} ms, p90 "
                  f"{float(np.percentile(ts, 90)):.3f} ms over {len(ts)} requests")
        if model_type in ("mobilenetv3large", "xception"):
            name = {"mobilenetv3large": "v3large"}.get(model_type, model_type)
            profile_one(torch, lambda: served.predict(*reqs[0]), f"one {model_type} request",
                        f"profile_one_request_{name}.txt", top=8)
        out[model_type] = launches
        del served, plain, configs
        torch.cuda.empty_cache()
    return out


def default_evaluation_path(torch, kernels, classes_path, root) -> None:
    """`python -m deeplabv3p_torch.eval` with its own default model
    (mobilenetv3large_lite), b8 512x512, on the 32 synthetic pairs and a
    seeded .npz: the confusion kernel once a batch, no other kernel, and
    the matrix EQUAL to torch.argmax + bincount on the same model's
    logits."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import accumulate_confusion
    from deeplabv3p_torch.utils.config import get_data_list
    from deeplabv3p_torch.utils.weights import (
        from_jax_variables,
        load_npz,
        save_npz,
        to_jax_variables,
    )

    weights = os.path.join(OUT_DIR, "smoke_v3_eval_weights.npz")
    seeded = build_deeplab_model("mobilenetv3large_lite", 21, device="cpu")
    init_parameters(seeded, torch.Generator().manual_seed(EVAL_SEED))
    save_npz(weights, to_jax_variables(seeded))
    argv = ["--model_path", weights, "--dataset_path", root, "--dataset_file",
            os.path.join(root, "list.txt"), "--classes_path", classes_path,
            "--out_dir", os.path.join(OUT_DIR, "smoke_v3_eval_result")]
    args = eval_cli.parse_args(argv)
    check((args.model_type, args.batch_size, args.model_input_shape) ==
          ("mobilenetv3large_lite", EVAL_BATCH, "512x512"),
          "eval CLI defaults: mobilenetv3large_lite, b8, 512x512")
    print("  python -m deeplabv3p_torch.eval " + " ".join(argv))
    m, wall, launches, text = run_cli(torch, kernels, eval_cli.main, args)
    batches = TRAIN_IMAGES // EVAL_BATCH
    summary = [ln for ln in text.splitlines() if "=" in ln and ":" not in ln]
    print(f"  {wall:.2f} s wall (set-up and first-call cuDNN tuning included); "
          f"{' '.join(summary)}; launch counts {launches}  [{card_line()}]")
    check(launches == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches},
          f"eval CLI, default model: the confusion kernel once a batch ({batches}), the lite "
          "head runs no other kernel")
    model = build_deeplab_model("mobilenetv3large_lite", 21, fused_aspp=True,
                                dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(from_jax_variables(load_npz(weights), model), strict=True)

    @torch.no_grad()
    def library_step(images_u8, labels_u8):
        images, labels = preprocess_eval_batch(images_u8, labels_u8, num_classes=21)
        preds = torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1)
        return metrics_lib.confusion_matrix(labels, preds, 21)

    ds = SegmentationDataset(root, get_data_list(os.path.join(root, "list.txt"), shuffle=False),
                             batch_size=EVAL_BATCH, num_classes=21, input_shape=INPUT,
                             augment=False, shuffle=False, drop_remainder=False)
    want = accumulate_confusion(library_step, ds, 21, "cuda")
    check(np.array_equal(m.confusion, want) and int(want.sum()) > 0,
          "eval CLI, default model: the matrix EQUALS torch.argmax + bincount on the same "
          f"model's logits (sum|diff| {int(np.abs(m.confusion - want).sum())})")


def default_train_numbers(torch, batch, steps: int = 6) -> None:
    """The CLI default's step (mobilenetv3large_lite b16 bf16, SGD at the
    CLI's LR, freeze level 0), each step augmenting the same uint8 batch
    anew on the card, unfused and --fused_loss in turns U F F U of `steps`
    after 2 warm-up steps each: step time (host clock, synchronized,
    augmentation included), img/s, peak memory, the augmentation's own time
    by CUDA events and its share of the step; the loss must be finite and
    fall over the steps."""
    from deeplabv3p_torch.data.augment import AugmentConfig, augment_batch
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import StageConfig, Trainer

    images_u8, labels_u8, orig_hw = batch
    model = build_deeplab_model("mobilenetv3large_lite", 21, dtype=torch.bfloat16,
                                device="cuda")
    init_parameters(model, torch.Generator().manual_seed(V3_SEED), bn_identity=True)
    trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device="cuda",
                      log_dir=os.path.join(OUT_DIR, "smoke_v3_step_logs"))
    stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-2)
    state = trainer.build_stage_state(stage)
    variants = {}
    for fused in (False, True):
        trainer.fused_loss = fused
        variants["--fused_loss" if fused else "default"] = trainer.make_train_step(stage)
    gen = torch.Generator(device="cuda").manual_seed(V3_SEED)
    cfg = AugmentConfig()
    losses = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run(step, n):
        times, aug = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            start.record()
            images, labels, weights = augment_batch(gen, images_u8, labels_u8, orig_hw, cfg,
                                                    num_classes=21)
            end.record()
            metrics = step(state, images, labels, weights)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            aug.append(start.elapsed_time(end))
            losses.append(metrics["loss"].item())
        return times, aug

    for step in variants.values():
        run(step, 2)
    times = {k: [] for k in variants}
    aug = {k: [] for k in variants}
    peak = {k: 0 for k in variants}
    for name in ("default", "--fused_loss", "--fused_loss", "default"):
        torch.cuda.reset_peak_memory_stats()
        t, a = run(variants[name], steps)
        times[name] += t
        aug[name] += a
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    card = card_line()
    print(f"train step with the CLI's defaults, mobilenetv3large_lite OS16 512x512 "
          f"b{TRAIN_BATCH} bf16, SGD, freeze level 0, the augmentation on the card each step, "
          f"in turns U F F U of {steps} steps (host clock, synchronized)  [{card}]:")
    for name, ts in times.items():
        med, aug_ms = statistics.median(ts), statistics.mean(aug[name])
        print(f"  {name}: median {med:.3f} ms, p90 {float(np.percentile(ts, 90)):.3f} ms over "
              f"{len(ts)} steps, {TRAIN_BATCH / med * 1e3:.1f} img/s; peak memory "
              f"{peak[name] / 2**20:.1f} MiB; augmentation {aug_ms:.3f} ms a b{TRAIN_BATCH} "
              f"batch by CUDA events (median {statistics.median(aug[name]):.3f}), "
              f"{aug_ms / med:.3f} of the step  [{card}]")
    profile_one(torch, lambda: augment_batch(gen, images_u8, labels_u8, orig_hw, cfg, 21),
                f"the augmentation of one b{TRAIN_BATCH} batch", "profile_one_augment.txt",
                top=12)
    profile_one(torch, lambda: variants["default"](state, *augment_batch(
        gen, images_u8, labels_u8, orig_hw, cfg, 21)), "one CLI-default step",
        "profile_one_train_step_v3.txt", top=8)
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(all(np.isfinite(losses)) and last < first,
          f"CLI-default training: {len(losses)} losses finite and falling (first four "
          f"{first:.4f}, last four {last:.4f}): {[round(x, 3) for x in losses]}")


def learning_proof(torch, kernels, train_main, train_args):
    """(a) The learning proof on the card: bench.py's `learn` recipe through
    `python -m deeplabv3p_torch.train` (mobilenetv2, the toy set of
    data/toy.py, 256x256, b8, adam 1e-3, cosine, adaptive weights,
    --no_augment, --freeze_level 1, 2 + 118 epochs, --bn_recalibrate), then
    `python -m deeplabv3p_torch.eval` on trained_final.npz: mIoU >= 0.95.
    The same weights written as the JAX package's .ckpt give the eval CLI
    the same matrix. Returns what phase (b) reuses."""
    import shutil

    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.data.toy import build_overfit_dataset
    from deeplabv3p_torch.utils.checkpoint import save_variables
    from deeplabv3p_torch.utils.weights import load_npz

    root = os.path.join(OUT_DIR, "smoke_learn_data")
    log_dir = os.path.join(OUT_DIR, "smoke_learn_logs")
    for d in (root, log_dir):
        shutil.rmtree(d, ignore_errors=True)
    list_path = build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    common = ["--model_type", "mobilenetv2", "--model_input_shape", str(LEARN_HW),
              "--batch_size", str(LEARN_BATCH), "--dataset_path", root, "--dataset_file",
              list_path, "--classes_path", os.path.join(root, "classes.txt")]
    argv = [*common, "--optimizer", "adam", "--learning_rate", "1e-3", "--decay_type", "cosine",
            "--weighted_type", "adaptive", "--no_augment", "--freeze_level", "1",
            "--transfer_epoch", "2", "--total_epoch", str(LEARN_EPOCHS), "--bn_recalibrate",
            "--log_dir", log_dir, "--device", "cuda"]
    print("learning proof: python -m deeplabv3p_torch.train " + " ".join(argv))
    trainer, train_s, train_launches, _ = run_cli(torch, kernels, train_main, train_args(argv))
    losses = [r["loss"] for r in trainer.history]
    check(len(losses) == LEARN_EPOCHS and all(np.isfinite(losses)),
          f"learning proof: {len(losses)} epochs of finite loss, first {losses[0]:.4f}, last "
          f"{losses[-1]:.4f}; train jaccard last {trainer.history[-1]['jaccard']:.4f}")
    check(train_launches == ZERO_LAUNCHES,
          f"learning proof, training: no hand-written kernel on this path (unfused loss, "
          f"training mode): {train_launches}")
    final = os.path.join(log_dir, "trained_final.npz")

    def evaluate(path, *extra):
        args = eval_cli.parse_args([*common, "--model_path", path, "--device", "cuda",
                                    "--out_dir", os.path.join(OUT_DIR, "smoke_learn_eval"),
                                    *extra])
        return run_cli(torch, kernels, eval_cli.main, args)

    m, eval_s, eval_launches, _ = evaluate(final)
    card = card_line()
    print(f"  trained {LEARN_EPOCHS} epochs ({LEARN_EPOCHS} steps of b{LEARN_BATCH}) in "
          f"{train_s:.2f} s (the CLI's wall: set-up, first-call cuDNN tuning and the BN "
          f"recalibration included); eval CLI {eval_s:.2f} s; {train_s + eval_s:.2f} s to the "
          f"eval's mIoU {m.miou:.5f} (FWIoU {m.fwiou:.5f}, PixelAcc {m.pixel_acc:.5f})  [{card}]")
    check(m.miou >= LEARN_TARGET, f"learning proof: eval mIoU {m.miou:.5f} >= {LEARN_TARGET}")
    batches = -(-8 // LEARN_BATCH)
    check(eval_launches == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                            "multirate_atrous_depthwise": batches},
          f"learning proof, eval: the confusion and ASPP kernels once a batch ({batches}): "
          f"{eval_launches}")
    ckpt = os.path.join(log_dir, "trained_final.ckpt")
    save_variables(ckpt, load_npz(final))
    m_ckpt = evaluate(ckpt)[0]
    check(np.array_equal(m_ckpt.confusion, m.confusion),
          f"learning proof: the weights as a .ckpt (save_variables) give the eval CLI the "
          f".npz's matrix (sum|diff| {int(np.abs(m_ckpt.confusion - m.confusion).sum())})")
    m_mb, _, mb_launches, _ = evaluate(final, "--fused_mbconv")
    check(mb_launches["fused_inverted_residual"] == 13 * batches,
          f"learning proof, eval --fused_mbconv: the inverted-residual kernel 13 times a batch "
          f"({mb_launches['fused_inverted_residual']})")
    print(f"  eval CLI --fused_mbconv on the trained weights: mIoU {m_mb.miou:.5f} against "
          f"{m.miou:.5f} by default")
    return {"root": root, "list": list_path, "weights": final, "launches": eval_launches,
            "miou": m.miou, "confusion": {"default": m.confusion, "fused_mbconv": m_mb.confusion}}


def fused_mbconv_on_trained_weights(torch, learn) -> None:
    """(b) ROADMAP Queue C item 1: the masks of --fused_mbconv against the
    default's, on the learning proof's trained weights and the toy images
    (bf16, 256x256, as the eval CLI builds the model); printed. Each route's
    masks agree with the f32 model's with no kernel on >= 0.98 of pixels, and
    torch.argmax + bincount of them EQUALS the eval CLI's matrix of (a) for
    that route (the confusion kernel at (8,256,256,4)). The default does not
    change here."""
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.utils.config import get_data_list
    from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz

    variables = load_npz(learn["weights"])
    ds = SegmentationDataset(learn["root"], get_data_list(learn["list"], shuffle=False),
                             batch_size=LEARN_BATCH, num_classes=4,
                             input_shape=(LEARN_HW, LEARN_HW), augment=False, shuffle=False,
                             drop_remainder=False)
    batches = [(b[0], b[1]) for b in ds.epoch_batches()]
    labels = torch.cat([preprocess_eval_batch(torch.from_numpy(images_u8).cuda(),
                                              torch.from_numpy(labels_u8).cuda(), 4)[1]
                        for images_u8, labels_u8 in batches])

    @torch.no_grad()
    def masks_of(dtype, **flags):
        model = build_deeplab_model("mobilenetv2", 4, dtype=dtype, device="cuda", **flags)
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        out = []
        for images_u8, labels_u8 in batches:
            images, _ = preprocess_eval_batch(torch.from_numpy(images_u8).cuda(),
                                              torch.from_numpy(labels_u8).cuda(), 4)
            out.append(torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1))
        return torch.cat(out)

    default = masks_of(torch.bfloat16, fused_aspp=True)
    fused = masks_of(torch.bfloat16, fused_aspp=True, fused_mbconv=True)
    f32 = masks_of(torch.float32)
    agree = (fused == default).float().mean().item()
    check(fused.shape == default.shape == (8, LEARN_HW, LEARN_HW),
          f"Queue C item 1, trained weights: --fused_mbconv masks agree with the default's "
          f"on {agree:.5f} of {default.numel()} pixels (0.98152 on seeded random weights)")
    for route, masks in (("default", default), ("fused_mbconv", fused)):
        to_f32 = (masks == f32).float().mean().item()
        check(to_f32 >= 0.98, f"trained weights, bf16 {route} vs f32 with no kernel: masks "
                              f"agree on {to_f32:.5f} >= 0.98 of pixels")
        want = metrics_lib.confusion_matrix(labels, masks, 4).cpu().numpy()
        got = learn["confusion"][route]
        check(np.array_equal(got, want) and int(want.sum()) > 0,
              f"learning proof, eval CLI ({route}): the matrix EQUALS torch.argmax + bincount "
              f"on the same model's logits (sum|diff| {int(np.abs(got - want).sum())})")


def xception_evaluation_path(torch, kernels, classes_path, root) -> int:
    """(c) `python -m deeplabv3p_torch.eval --model_type xception` on the 32
    synthetic pairs at b8 and a seeded .npz: the ASPP kernel at
    (8,32,32,2048) and the confusion kernel once a batch. Returns the ASPP
    launches."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

    weights = os.path.join(OUT_DIR, "smoke_xception_weights.npz")
    seeded = build_deeplab_model("xception", 21, device="cpu")
    init_parameters(seeded, torch.Generator().manual_seed(EVAL_SEED))
    save_npz(weights, to_jax_variables(seeded))
    del seeded
    argv = [*eval_argv(weights, root, classes_path, os.path.join(OUT_DIR, "smoke_x_eval"))]
    argv[argv.index("mobilenetv2")] = "xception"
    print("  python -m deeplabv3p_torch.eval " + " ".join(argv))
    m, wall, launches, _ = run_cli(torch, kernels, eval_cli.main, eval_cli.parse_args(argv))
    batches = TRAIN_IMAGES // EVAL_BATCH
    print(f"  xception eval: {wall:.2f} s wall (set-up and first-call cuDNN tuning included), "
          f"mIoU {m.miou:.5f} (seeded weights); launch counts {launches}  [{card_line()}]")
    check(launches == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                       "multirate_atrous_depthwise": batches}
          and int(m.confusion.sum()) > 0,
          f"xception eval b{EVAL_BATCH}: the ASPP kernel at 2048 channels and the confusion "
          f"kernel once a batch ({batches})")
    return launches["multirate_atrous_depthwise"]


def xception_training_path(torch, kernels, train_main, train_args, classes_path, root):
    """(d) `python -m deeplabv3p_torch.train --model_type xception` b8 bf16
    512x512 --no_augment --fused_loss --optim_state_dtype bfloat16 at the
    CLI's own LR (SGD 1e-2), 1 + 1 epochs of 4 steps on the 32 synthetic
    pairs: the loss kernels once a step, no other kernel, finite losses.
    Returns the launch counts."""
    import shutil

    log_dir = os.path.join(OUT_DIR, "smoke_x_train_logs")
    shutil.rmtree(log_dir, ignore_errors=True)
    argv = ["--model_type", "xception", "--model_input_shape", f"{INPUT[0]}x{INPUT[1]}",
            "--batch_size", str(XCEPTION_BATCH), "--no_augment", "--fused_loss",
            "--optim_state_dtype", "bfloat16",
            "--transfer_epoch", "1", "--total_epoch", "2",
            "--dataset_path", root, "--dataset_file", os.path.join(root, "list.txt"),
            "--classes_path", classes_path, "--log_dir", log_dir, "--device", "cuda"]
    print("  python -m deeplabv3p_torch.train " + " ".join(argv))
    trainer, wall, launches, _ = run_cli(torch, kernels, train_main, train_args(argv))
    steps = 2 * (TRAIN_IMAGES // XCEPTION_BATCH)
    print(f"  xception: {steps} steps in {wall:.1f} s wall (set-up and first-call cuDNN tuning "
          f"included); launch counts {launches}")
    check(launches == {**ZERO_LAUNCHES, "upsample_ce_forward": steps,
                       "upsample_ce_backward": steps},
          f"xception training --fused_loss: each loss kernel once a step ({steps}), every "
          "other kernel never")
    hist = trainer.history
    check(len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist),
          f"xception training: 2 epochs, finite losses {[round(r['loss'], 5) for r in hist]}")
    return launches


def xception_train_numbers(torch, root, classes_path, steps: int = 6) -> None:
    """(d) xception b8 bf16 512x512 train steps (SGD 1e-2, freeze level 0,
    one fixed batch of the synthetic set): unfused with f32 state (U),
    --fused_loss (F) and --optim_state_dtype bfloat16 (B), each its own
    model from the same seed, in turns U F B B F U of `steps` after 2
    warm-up steps: step time, img/s, peak memory, the optimizer state's
    bytes; the loss must fall in each run."""
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import StageConfig, Trainer

    images, labels = train_batch(torch, root, classes_path)
    images, labels = images[:XCEPTION_BATCH], labels[:XCEPTION_BATCH]
    variants = {}
    for name, fused, state_dtype in (("U unfused, f32 state", False, None),
                                     ("F --fused_loss, f32 state", True, None),
                                     ("B unfused, bf16 state", False, "bfloat16")):
        model = build_deeplab_model("xception", 21, dtype=torch.bfloat16, device="cuda")
        init_parameters(model, torch.Generator().manual_seed(TRAIN_SEED), bn_identity=True)
        trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device="cuda",
                          log_dir=os.path.join(OUT_DIR, "smoke_x_step_logs"), fused_loss=fused)
        stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-2,
                            state_dtype=state_dtype)
        variants[name] = (trainer.build_stage_state(stage), trainer.make_train_step(stage))
    losses = {name: [] for name in variants}

    def run(name, n):
        state, step = variants[name]
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step(state, images, labels, None)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses[name].append(metrics["loss"].item())
        return times

    for name in variants:
        run(name, 2)
    times = {name: [] for name in variants}
    peak = {name: 0 for name in variants}
    for name in [*variants, *reversed(variants)]:
        torch.cuda.reset_peak_memory_stats()
        times[name] += run(name, steps)
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())

    def resident(name):
        """Bytes of a variant's weights and optimizer state (its gradients are
        freed after each step)."""
        state = variants[name][0]
        opt = sum(t.numel() * t.element_size() for s in state.optimizer.state.values()
                  for t in s.values() if isinstance(t, torch.Tensor))
        params = sum(p.numel() * p.element_size() for p in state.params.values())
        return params, opt

    card = card_line()
    n_params = sum(p.numel() for p in variants["U unfused, f32 state"][0].params.values())
    print(f"train step, xception OS16 512x512 b{XCEPTION_BATCH} bf16, SGD, freeze level 0, "
          f"{n_params} parameters, in turns U F B B F U of {steps} steps (host clock, "
          f"synchronized)  [{card}]:")
    for name, ts in times.items():
        med = statistics.median(ts)
        params, opt = resident(name)
        others = sum(sum(resident(o)) for o in variants if o != name)
        print(f"  {name}: median {med:.3f} ms, p90 {float(np.percentile(ts, 90)):.3f} ms over "
              f"{len(ts)} steps, {XCEPTION_BATCH / med * 1e3:.1f} img/s; peak memory "
              f"{peak[name] / 2**20:.1f} MiB with all three variants resident, "
              f"{(peak[name] - others) / 2**20:.1f} MiB less the other two's weights and "
              f"state; its optimizer state {opt / 2**20:.1f} MiB, weights {params / 2**20:.1f} "
              f"MiB  [{card}]")
        first, last = statistics.mean(losses[name][:4]), statistics.mean(losses[name][-4:])
        check(all(np.isfinite(losses[name])) and last < first,
              f"xception training {name}: {len(losses[name])} losses finite and falling "
              f"(first four {first:.4f}, last four {last:.4f})")
    state_saved = resident("U unfused, f32 state")[1] - resident("B unfused, bf16 state")[1]
    print(f"  bf16 optimizer state saves {state_saved / 2**20:.1f} MiB "
          f"({state_saved / n_params:.2f} bytes a parameter)")
    del variants
    torch.cuda.empty_cache()


def aspp_shape_row(torch, kaspp, rec, launches, path) -> dict:
    """The ASPP kernel's kernels-JSON record at a new shape: its check's
    error, its times against the plain version, and its launches on `path`,
    the run that calls it at that shape."""
    t = aspp_timing(torch, kaspp, rec["case"], iters=200)
    return {"name": "multirate_atrous_depthwise", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/aspp.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/aspp.py:85", "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "device_us": t["device_us"], "shape": t["shape"], "dtype": t["dtype"],
            "path": path}


def train_batch(torch, root, classes_path):
    """The first TRAIN_BATCH pairs of the synthetic set, preprocessed on the
    card: (images f32 NHWC, labels int32)."""
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset

    ids = [f"s{i:03d}" for i in range(TRAIN_BATCH)]
    ds = SegmentationDataset(root, ids, batch_size=TRAIN_BATCH, num_classes=21,
                             input_shape=INPUT, augment=False, shuffle=False)
    images, labels, _ = next(iter(ds.epoch_batches()))
    return preprocess_eval_batch(torch.from_numpy(images).cuda(),
                                 torch.from_numpy(labels).cuda(), num_classes=21)


def make_train_model(torch, dtype, seed):
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters

    model = build_deeplab_model("mobilenetv2", 21, dtype=dtype, device="cuda")
    init_parameters(model, torch.Generator().manual_seed(seed), bn_identity=True)
    return model


def fused_vs_unfused(torch, batch) -> None:
    """Forward + loss + backward of the train step, fused and unfused, from
    the same weights on the same batch, dropout off, TF32 off, deterministic
    cuDNN. Losses: f32 within 1e-5 relative, bf16 within 1e-2. Gradients:
    each within 1e-4 of its max|grad| (floored at 1e-2 of the model's
    largest: the linear bottlenecks' project_BN biases feed a 1x1 conv and a
    training-mode BN, so their gradient is exactly 0 and carries only
    rounding), with f64 activations (f32 parameters, f32 loss tail and
    kernels, as in training). In f32 activations the backward's own
    reductions over 4 M pixels, in a random-init stack of training-mode BNs,
    amplify rounding past 1e-4 on a few BN scales whichever loss tail runs;
    that worst ratio is printed too."""
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.models.layers import Dropout
    from deeplabv3p_torch.train import make_train_step

    images, labels = batch
    torch.backends.cudnn.deterministic = True
    results = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for fused in (False, True):
            model = make_train_model(torch, dtype, seed=1)
            for m in model.modules():
                if isinstance(m, Dropout):
                    m.rate = 0.0
            step = make_train_step(model, get_loss_fn("crossentropy"), num_classes=21,
                                   fused_loss=fused)
            loss, _ = step.forward_loss(images, labels, None)
            loss.backward()
            grads = {n: p.grad.double() for n, p in model.named_parameters()}
            results[dtype, fused] = (loss.item(), grads)
            del model, step, loss
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False

    def worst(dtype):
        gu, gf = results[dtype, False][1], results[dtype, True][1]
        top = max(g.abs().max().item() for g in gu.values())
        ratios = sorted((((gf[n] - gu[n]).abs().max().item()
                          / max(gu[n].abs().max().item(), 1e-2 * top), n) for n in gu),
                        reverse=True)
        return ratios, top

    for dtype, tol in ((torch.float64, 1e-5), (torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        lu, lf = results[dtype, False][0], results[dtype, True][0]
        check(abs(lf - lu) <= tol * abs(lu),
              f"train step {dtype}: fused loss {lf:.8g} vs unfused {lu:.8g} ({tol:g} relative)")
    ratios, top = worst(torch.float64)
    check(ratios[0][0] <= 1e-4,
          f"train step, f64 activations: every gradient within 1e-4 of its max|grad| "
          f"(largest {top:.3g}); worst {ratios[0][0]:.3g} {ratios[0][1]}")
    ratios, top = worst(torch.float32)
    print(f"  (f32 activations, for the record: worst {ratios[0][0]:.3g} {ratios[0][1]}, "
          f"then {ratios[1][0]:.3g} {ratios[1][1]}, {ratios[2][0]:.3g} {ratios[2][1]})")


def train_step_numbers(torch, batch, steps: int = 12) -> None:
    """bf16 train-step time (host clock, synchronized), fused and unfused
    in turns U F F U of `steps` steps after 2 warm-up steps, img/s and peak
    memory; then the profile of one fused step."""
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.train import StageConfig, Trainer

    images, labels = batch
    model = make_train_model(torch, torch.bfloat16, seed=2)
    trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device="cuda",
                      log_dir=os.path.join(OUT_DIR, "smoke_step_logs"))
    stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-3)
    state = trainer.build_stage_state(stage)
    variants = {}
    for fused in (False, True):
        trainer.fused_loss = fused
        variants["fused" if fused else "unfused"] = trainer.make_train_step(stage)

    def run(step, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, images, labels, None)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    for step in variants.values():
        run(step, 2)
    times = {k: [] for k in variants}
    peak = {k: 0 for k in variants}
    for name in ("unfused", "fused", "fused", "unfused"):
        torch.cuda.reset_peak_memory_stats()
        times[name] += run(variants[name], steps)
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    print(f"train step, mobilenetv2 OS16 512x512 b{TRAIN_BATCH} bf16, SGD, freeze level 0, "
          f"in turns U F F U of {steps} steps (host clock, synchronized):")
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"  {name}: median {med:.3f} ms, p90 {float(np.percentile(ts, 90)):.3f} ms "
              f"over {len(ts)} steps, {TRAIN_BATCH / med * 1e3:.1f} img/s; peak memory "
              f"{peak[name] / 2**20:.1f} MiB (max_memory_allocated)")
    profile_one(torch, lambda: variants["fused"](state, images, labels, None),
                "one fused train step", "profile_one_train_step.txt", top=15)


def upsample_ce_times(torch, kce, rec, launches) -> list:
    """Each loss-tail kernel's time against its plain version at the
    training slice's shape, and its kernels-JSON row."""
    logits, labels, wpx, out_hw, lse = rec["case"]
    rows = []
    pixel_classes = labels.numel() * logits.shape[-1]
    # forward: logits, labels and weights read, preds (int32) and lse written; a
    # (pixel, class) costs 3 lerps, an exp, a max and an add. Backward: the same
    # reads plus lse, the low-resolution gradient written; a (pixel, class) costs
    # the 3 lerps, an exp, the softmax - onehot and 4 multiply-adds of the scatter
    fwd_bound = bound(nbytes(logits, labels, wpx, lse) + 4 * labels.numel(), pixel_classes * 10)
    bwd_bound = bound(nbytes(logits, labels, wpx, lse, logits), pixel_classes * 18)
    for name, fn, plain, err, replaces, (bound_ms, bound_by) in (
        ("upsample_ce_forward", lambda: kce.upsample_ce_forward(logits, labels, wpx, out_hw),
         lambda: kce.upsample_ce_reference(logits, labels, out_hw, sample_weights=wpx),
         rec["fwd_err"], "deeplabv3p_tpu/ops/pallas/upsample_ce.py:242", fwd_bound),
        ("upsample_ce_backward",
         lambda: kce.upsample_ce_backward(logits, labels, wpx, lse, out_hw),
         lambda: kce.upsample_ce_backward_reference(logits, labels, wpx, out_hw),
         rec["bwd_err"], "deeplabv3p_tpu/ops/pallas/upsample_ce.py:267", bwd_bound),
    ):
        ms, plain_ms = ab_ms(fn, plain, iters=20)
        dev_us, dev_launches = device_us(torch, fn, calls=10)
        plain_us, plain_launches = device_us(torch, plain, calls=10)
        print(f"{name}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a call (CUDA "
              f"events, mean of 2x20 calls each, {tuple(logits.shape)} -> {out_hw}); device "
              f"time a call (profiler): kernel {us_text(dev_us)} in {dev_launches} launch(es), "
              f"plain {us_text(plain_us)} in {plain_launches}")
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplabv3p_torch/ops/kernels/csrc/upsample_ce.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "device_us": dev_us})
    return rows


# -- the confusion and inverted-residual kernels, and the evaluation path --------


def confusion_case(torch, shape, dtype, label_dtype, seed=0):
    """Seeded logits with planted exact ties and NaNs, labels with a 255
    band, values above C-1 and, where the type is signed, negatives."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    logits = torch.randn(shape, generator=gen)
    flat = logits.reshape(-1, c)
    n = flat.shape[0]
    tie = torch.arange(0, n, 7)
    flat[tie] = flat[tie].max(dim=1, keepdim=True).values    # every class ties
    pair = torch.arange(3, n, 11)
    flat[pair, c - 1] = flat[pair].max(dim=1).values          # the last class ties the max
    flat[torch.arange(5, n, 13), 0] = float("nan")
    flat[torch.arange(2, n, 17)] = float("nan")                # all-NaN pixels
    labels = torch.randint(0, c + 3, shape[:-1], generator=gen, dtype=torch.int64)
    labels.reshape(-1)[: n // 9] = 255
    if label_dtype != torch.uint8:
        labels.reshape(-1)[n // 2: n // 2 + n // 10] = -1
    return labels.to(label_dtype).cuda(), logits.to(dtype).cuda()


def confusion_check(torch, kconf, shape, dtype_name, label_name) -> dict:
    dtype, label_dtype = getattr(torch, dtype_name), getattr(torch, label_name)
    labels, logits = confusion_case(torch, shape, dtype, label_dtype)
    c = shape[-1]
    got = kconf.confusion_matrix_fused(labels, logits, c)
    torch.cuda.synchronize()
    want = kconf.confusion_matrix_fused_reference(labels, logits, c)
    valid = ((labels.long() >= 0) & (labels.long() < c)).sum().item()
    diff = (got - want).abs().sum().item()
    check(diff == 0 and got.sum().item() == valid and got.dtype == torch.int64,
          f"confusion {shape} {dtype_name} logits, {label_name} labels: sum|kernel - plain| "
          f"{diff} == 0, counts {got.sum().item()} == valid label pixels {valid}")
    return {"max_abs_err": float(diff), "case": (labels, logits, c)}


def argmax_check(torch, kconf, mask_argmax) -> None:
    """jnp.argmax's rule on the card: the first index wins a tie and the
    first NaN wins over numbers. mask_argmax (torch.argmax, the serving and
    --save_result route) and the confusion kernel (the eval route) against
    numpy's argmax on the same planted logits, in f32 and bf16."""
    gen = torch.Generator().manual_seed(5)
    c = 21
    logits = torch.randn((2, 97, 113, c), generator=gen)
    flat = logits.reshape(-1, c)
    flat[0::7] = flat[0::7].max(dim=1, keepdim=True).values      # every class ties
    flat[3::11, c - 1] = flat[3::11].max(dim=1).values           # the last class ties
    flat[5::13, 4] = float("nan")                                 # a NaN among numbers
    flat[6::13, 2] = flat[6::13, 9] = float("nan")               # two: the first wins
    flat[2::17] = float("nan")                                    # all NaN
    labels = torch.randint(0, c + 2, logits.shape[:-1], generator=gen, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        z = logits.to(dtype)
        want = np.argmax(z.float().numpy(), axis=-1)
        got = mask_argmax(z.cuda()).cpu().numpy()
        lab = labels.numpy()
        valid = lab < c
        cm_want = np.bincount(c * lab[valid].astype(np.int64) + want[valid],
                              minlength=c * c).reshape(c, c)
        cm = kconf.confusion_matrix_fused(labels.cuda(), z.cuda(), c).cpu().numpy()
        check(np.array_equal(got, want) and np.array_equal(cm, cm_want),
              f"argmax on the card, {dtype}: mask_argmax equals numpy's argmax on "
              f"{want.size} pixels with planted ties and NaNs ({int((got != want).sum())} "
              f"differ); the confusion kernel's matrix equals numpy's bincount of it "
              f"(sum|diff| {int(np.abs(cm - cm_want).sum())})")


def body_block_shapes(batch: int, hw) -> list[tuple]:
    """(n, h, w, cin, cexp, cout, rate, residual) of every block of the
    MobileNetV2 OS16 body that `fused_mbconv` routes through the kernel, read
    off the model itself."""
    from deeplabv3p_torch.models.factory import build_deeplab_model

    body = build_deeplab_model("mobilenetv2", 21, output_stride=16, device="cpu").backbone
    h, w = (hw[0] + 1) // 2, (hw[1] + 1) // 2  # the stem's stride 2
    shapes = []
    for i in range(17):
        block = getattr(body, f"block_{i}")
        if block.stride == 2:
            h, w = (h + 1) // 2, (w + 1) // 2
        elif block.has_expand:
            cexp, cin = block._sub("expand").weight.shape[:2]
            shapes.append((batch, h, w, cin, cexp, block.out_channels, block.rate,
                           block.skip_connection))
    return shapes


def mbconv_case(torch, shape, dtype, seed=0):
    """Seeded block input and parameters as the JAX package's test draws them."""
    n, h, w, cin, cexp, cout = shape[:6]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=gen).cuda().to(dtype)
    we = (torch.randn((cin, cexp), generator=gen) * 0.2).cuda()
    wd = (torch.randn((3, 3, cexp), generator=gen) * 0.2).cuda()
    wp = (torch.randn((cexp, cout), generator=gen) * 0.1).cuda()

    def fold(c):
        return ((torch.rand((c,), generator=gen) + 0.5).cuda(),
                torch.randn((c,), generator=gen).cuda())

    (se, be), (sd, bd), (sp, bp) = fold(cexp), fold(cexp), fold(cout)
    return x, we, se, be, wd, sd, bd, wp, sp, bp


def mbconv_checks(torch, kmb, body_shapes,
                  others=(*MBCONV_TEST_CASES, *MBCONV_EXTRA_CASES)) -> dict:
    """The inverted-residual kernel against its plain version at the body's
    13 shapes and `others` (by default the JAX tests' four, a ragged map and
    OS8's rate 4), bf16 and f32, the weights prepared on the fly as a caller without a module has
    them. Both store e and d as
    bf16, and their f32 sums differ in order, so a sum an ulp apart can round
    to the other bf16 neighbour (2^-8 relative on one of Cexp terms): both x
    types are held to the bf16 bound of `tolerance`."""
    worst = 0.0
    for shape in [*body_shapes, *others]:
        rate, residual = shape[6], shape[7]
        for dtype in (torch.bfloat16, torch.float32):
            args = mbconv_case(torch, shape, dtype)
            got = kmb.fused_inverted_residual(*args, rate=rate, residual=residual)
            torch.cuda.synchronize()
            want = kmb.fused_inverted_residual_reference(*args, rate=rate, residual=residual)
            err, ref = max_err(got, want)
            mean = (got.float() - want.float()).abs().mean().item()
            tol = tolerance(ref, torch.bfloat16)
            check(err <= tol and got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"mbconv {shape} {dtype}: max|err| {err:.3g} <= {tol:.3g} (mean|err| "
                  f"{mean:.3g}, max|ref| {ref:.3g})")
            if shape in body_shapes and dtype == torch.bfloat16:
                worst = max(worst, err)
            del args, got, want
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "shapes": body_shapes}


def eval_argv(weights, root, classes_path, out_dir, *extra):
    return ["--model_path", weights, "--model_type", "mobilenetv2", "--model_input_shape",
            f"{INPUT[0]}x{INPUT[1]}", "--output_stride", "16", "--batch_size", str(EVAL_BATCH),
            "--dataset_path", root, "--dataset_file", os.path.join(root, "list.txt"),
            "--classes_path", classes_path, "--out_dir", out_dir, *extra]


def evaluation_path(torch, kernels, classes_path, root):
    """`deeplabv3p_torch.eval.main` in-process, twice (as built by default,
    then `--fused_mbconv`), on the synthetic set and a seeded .npz. Returns
    the two runs' launch counts and what the timing phase reuses."""
    from deeplabv3p_torch import eval as eval_cli
    from deeplabv3p_torch import metrics as metrics_lib
    from deeplabv3p_torch.data.augment import preprocess_eval_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import accumulate_confusion, make_eval_step
    from deeplabv3p_torch.utils.config import get_data_list
    from deeplabv3p_torch.utils.weights import (
        from_jax_variables,
        load_npz,
        save_npz,
        to_jax_variables,
    )

    out_dir = os.path.join(OUT_DIR, "smoke_eval_result")
    weights = os.path.join(OUT_DIR, "smoke_eval_weights.npz")
    seeded = build_deeplab_model("mobilenetv2", 21, device="cpu")
    init_parameters(seeded, torch.Generator().manual_seed(EVAL_SEED))
    save_npz(weights, to_jax_variables(seeded))
    batches = TRAIN_IMAGES // EVAL_BATCH
    print(f"evaluation path: python -m deeplabv3p_torch.eval on {TRAIN_IMAGES} pairs of {INPUT}, "
          f"b{EVAL_BATCH}, seeded weights (seed {EVAL_SEED}) in {weights}")

    runs = []
    for extra in ((), ("--fused_mbconv",)):
        argv = eval_argv(weights, root, classes_path, out_dir, *extra)
        print("  " + " ".join(argv))
        m, wall, launches, text = run_cli(torch, kernels, eval_cli.main,
                                          eval_cli.parse_args(argv))
        summary = [ln for ln in text.splitlines() if "=" in ln and ":" not in ln]
        print(f"  {wall:.2f} s wall (set-up and first-call cuDNN tuning included); "
              f"{' '.join(summary)}; launch counts {launches}")
        check([ln.split("=")[0] for ln in summary[-4:]] == ["mIoU", "FWIoU", "PixelAcc",
                                                            "mClassAcc"],
              f"eval CLI {' '.join(extra) or '(default)'} printed its summary (mIoU= ...)")
        runs.append((m, launches))
    (m_default, l_default), (m_mbconv, l_mbconv) = runs
    check(l_default == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                        "multirate_atrous_depthwise": batches},
          f"eval, default: confusion and ASPP kernels once a batch ({batches}), "
          "inverted-residual, decoder and loss kernels never")
    check(l_mbconv == {**ZERO_LAUNCHES, "confusion_matrix_fused": batches,
                       "multirate_atrous_depthwise": batches,
                       "fused_inverted_residual": 13 * batches},
          f"eval, --fused_mbconv: the inverted-residual kernel 13 times a batch "
          f"({13 * batches}), confusion and ASPP once a batch")

    # -- references from the same weights, on the same batches -------------------
    variables = load_npz(weights)
    ids = get_data_list(os.path.join(root, "list.txt"), shuffle=False)
    ds = SegmentationDataset(root, ids, batch_size=EVAL_BATCH, num_classes=21,
                             input_shape=INPUT, augment=False, shuffle=False,
                             drop_remainder=False)
    host_batches = [(b[0], b[1]) for b in ds.epoch_batches()]
    valid = sum(int((b[1] < 21).sum()) for b in host_batches)

    def model_of(dtype, **flags):
        model = build_deeplab_model("mobilenetv2", 21, dtype=dtype, device="cuda", **flags)
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        return model

    def library_step(model):
        """The eval step with the library's tail: torch.argmax, then bincount."""
        @torch.no_grad()
        def step(images_u8, labels_u8):
            images, labels = preprocess_eval_batch(images_u8, labels_u8, num_classes=21)
            preds = torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1)
            return metrics_lib.confusion_matrix(labels, preds, 21)
        return step

    class Resident:
        """The decoded batches, as a dataset the shared loop can stream."""

        def epoch_batches(self):
            return iter(host_batches)

    @torch.no_grad()
    def masks_of(model):
        out = []
        for images_u8, labels_u8 in host_batches:
            images, _ = preprocess_eval_batch(torch.from_numpy(images_u8).cuda(),
                                              torch.from_numpy(labels_u8).cuda(), 21)
            out.append(torch.argmax(model(images.permute(0, 3, 1, 2)), dim=1))
        return torch.cat(out)

    bf16, f32 = torch.bfloat16, torch.float32
    served = model_of(bf16, fused_aspp=True)                      # what the CLI builds
    with_mbconv = model_of(bf16, fused_aspp=True, fused_mbconv=True)
    plain = model_of(bf16)                                        # every kernel off
    cm = m_default.confusion
    check(int(cm.sum()) == valid and cm.shape == (21, 21),
          f"eval, default: the (21, 21) matrix counts every valid label pixel "
          f"({int(cm.sum())} == {valid})")
    same_logits = accumulate_confusion(library_step(served), Resident(), 21, "cuda")
    check(np.array_equal(cm, same_logits),
          "eval, default: the matrix EQUALS torch.argmax + bincount on the same model's "
          f"logits (sum|diff| {int(np.abs(cm - same_logits).sum())})")
    # Every kernel off: the plain ASPP branch rounds its depthwise output to
    # bf16 twice where the kernel's route rounds once, so bf16 logits differ
    # by ulps and near-tie pixels flip; each flip moves two cells.
    no_kernels = accumulate_confusion(library_step(plain), Resident(), 21, "cuda")
    flips = int(np.abs(cm - no_kernels).sum()) // 2
    check(int(no_kernels.sum()) == valid and flips <= 0.01 * valid,
          f"eval, default vs every kernel off (bf16, torch.argmax + bincount): {flips} of "
          f"{valid} pixels counted in another cell (<= 1 %; equal: {flips == 0})")
    kern32 = accumulate_confusion(make_eval_step(model_of(f32, fused_aspp=True), 21),
                                  Resident(), 21, "cuda")
    plain32 = accumulate_confusion(library_step(model_of(f32)), Resident(), 21, "cuda")
    flips32 = int(np.abs(kern32 - plain32).sum()) // 2
    check(flips32 <= 1e-4 * valid,
          f"eval in f32, ASPP + confusion kernels vs every kernel off: {flips32} of {valid} "
          f"pixels counted in another cell (<= 0.01 %; equal: {flips32 == 0})")
    masks = {"default": masks_of(served), "--fused_mbconv": masks_of(with_mbconv)}
    agree = (masks["default"] == masks["--fused_mbconv"]).float().mean().item()
    check(agree >= 0.98, f"eval, --fused_mbconv vs default: masks agree on {agree:.5f} of "
                         "pixels (>= 0.98)")
    # for the record: each bf16 route against the f32 model with every kernel off
    # (the kernel keeps the block's weights f32, the standard route rounds them)
    masks32 = masks_of(model_of(f32))
    print("  masks against the f32 model with no kernel: " + ", ".join(
        f"{name} {(m == masks32).float().mean().item():.5f}" for name, m in masks.items()))
    check(abs(m_mbconv.miou - m_default.miou) <= 0.005 and int(m_mbconv.confusion.sum()) == valid,
          f"eval, --fused_mbconv: mIoU {m_mbconv.miou:.5f} within 0.005 of the default's "
          f"{m_default.miou:.5f}, every valid pixel counted")
    logits = served(preprocess_eval_batch(torch.from_numpy(host_batches[0][0]).cuda(),
                                          torch.from_numpy(host_batches[0][1]).cuda(),
                                          21)[0].permute(0, 3, 1, 2))
    check(logits.permute(0, 2, 3, 1).is_contiguous() and logits.dtype == f32,
          "the model's f32 logits are channels_last: the kernel's NHWC view is no copy")
    state = {"ds": ds, "resident": Resident(), "served": served, "with_mbconv": with_mbconv,
             "plain": plain, "library_step": library_step, "batch": host_batches[0]}
    return (l_default, l_mbconv), state


def eval_numbers(torch, state) -> None:
    """Images/s of the eval loop (host clock around the shared accumulation
    loop, which ends in the matrix's copy to the host): as the CLI builds it,
    with `--fused_mbconv`, and with no kernel (plain ASPP, torch.argmax +
    bincount), in turns N D M M D N; through the dataset (JPEG decode
    included) and on the decoded batches. Then the profile of one batch."""
    from deeplabv3p_torch.train import accumulate_confusion, make_eval_step

    steps = {"no kernels": state["library_step"](state["plain"]),
             "default (ASPP + confusion kernels)": make_eval_step(state["served"], 21),
             "--fused_mbconv": make_eval_step(state["with_mbconv"], 21)}
    card = card_line()
    for source, data, rounds in (("through the dataset (decode included)", state["ds"], 1),
                                 ("on decoded batches", state["resident"], 3)):
        for step in steps.values():
            accumulate_confusion(step, data, 21, "cuda")  # warm-up
        times = {name: [] for name in steps}
        for name in [*steps, *reversed(steps)]:
            for _ in range(rounds):
                torch.cuda.synchronize()
                t = time.perf_counter()
                accumulate_confusion(steps[name], data, 21, "cuda")
                times[name].append(time.perf_counter() - t)
        print(f"eval loop, mobilenetv2 OS16 512x512 b{EVAL_BATCH} bf16, {TRAIN_IMAGES} images a "
              f"pass, {source}, in turns N D M M D N  [{card}]:")
        for name, ts in times.items():
            med = statistics.median(ts)
            print(f"  {name}: median {med * 1e3:.2f} ms a pass over {len(ts)} passes "
                  f"(min {min(ts) * 1e3:.2f}, max {max(ts) * 1e3:.2f}), "
                  f"{TRAIN_IMAGES / med:.1f} img/s")
    images = torch.from_numpy(state["batch"][0]).cuda()
    labels = torch.from_numpy(state["batch"][1]).cuda()
    step = steps["default (ASPP + confusion kernels)"]
    profile_one(torch, lambda: step(images, labels), "one eval batch (b8, device-resident)",
                "profile_one_eval_batch.txt", top=14)
    step = steps["--fused_mbconv"]
    profile_one(torch, lambda: step(images, labels), "one eval batch with --fused_mbconv",
                "profile_one_eval_batch_fused_mbconv.txt", top=8)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def confusion_times(torch, kconf, rec, launches) -> dict:
    """The confusion kernel's time against its plain version at the eval
    slice's shape, and beside it the library's two calls: torch.argmax to an
    int64 map, then torch.bincount of the joint index (the index arithmetic
    between them is not timed)."""
    labels, logits, c = rec["case"]
    ms, plain_ms = ab_ms(lambda: kconf.confusion_matrix_fused(labels, logits, c),
                         lambda: kconf.confusion_matrix_fused_reference(labels, logits, c),
                         iters=20)
    preds = torch.argmax(logits, dim=-1)
    gt = labels.reshape(-1).long()
    idx = torch.where((gt >= 0) & (gt < c), c * gt + preds.reshape(-1),
                      torch.full_like(gt, c * c))
    argmax_ms = event_ms(lambda: torch.argmax(logits, dim=-1), 20)
    bincount_ms = event_ms(lambda: torch.bincount(idx, minlength=c * c + 1), 20)
    # each logit and label read once, the (C, C) int64 matrix written once; one
    # compare a logit
    bound_ms, bound_by = bound(nbytes(labels, logits) + 8 * c * c, logits.numel())
    print(f"confusion_matrix_fused: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a "
          f"call (CUDA events, mean of 2x20 calls each, {tuple(logits.shape)} {logits.dtype} "
          f"logits, {labels.dtype} labels); the library's two calls: torch.argmax "
          f"{argmax_ms * 1e3:.2f} us + torch.bincount {bincount_ms * 1e3:.2f} us  [{card_line()}]")
    return {"name": "confusion_matrix_fused", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/confusion.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/confusion.py:67",
            "launches": launches["confusion_matrix_fused"], "max_abs_err": rec["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": argmax_ms + bincount_ms,
            "library_calls": {"torch.argmax": argmax_ms, "torch.bincount": bincount_ms}}


def mbconv_bound(shape, n_bytes: float) -> tuple[float, str]:
    """(least ms, which limit): the two 1x1 products, counted once (not per
    weight part, not per halo recompute), at the tensor cores' dense bf16
    rate plus the 3x3 depthwise stencil at the f32 FMA rate, or the bytes
    over the memory rate, whichever is larger."""
    n, h, w, cin, cexp, cout = shape[:6]
    by_ops = (2 * n * h * w * (cin * cexp + cexp * cout) / BF16_TENSOR_FLOPS
              + 2 * 9 * n * h * w * cexp / F32_FLOPS) * 1e3
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def mbconv_times(torch, kmb, rec, launches, state) -> dict:
    """The inverted-residual kernel at each of the body's 13 shapes (bf16,
    batch 8) against its plain version and its bound, and each block of the
    body as a module, fused against its standard route (bf16 convolutions,
    f32 BatchNorm, relu6). The kernel is timed as the module calls it, with
    its weights prepared once; the time of a call that prepares them on the
    fly is printed beside it. The JSON row's times are sums over the 13
    shapes: one forward's worth of calls."""
    from deeplabv3p_torch.ops.kernels._build import load_library

    rows = []
    card = card_line()
    body = state["with_mbconv"].backbone
    blocks = [b for b in (getattr(body, f"block_{i}") for i in range(17))
              if b.has_expand and b.stride == 1]
    print(f"fused_inverted_residual at the body's 13 shapes, bf16 (CUDA events, mean of 2x20 "
          f"calls each; device = the profiler's kernel time; module = the block as the model "
          f"calls it)  [{card}]:")
    for shape, block in zip(rec["shapes"], blocks):
        n, h, w, cin, cexp, cout, rate, residual = shape
        args = mbconv_case(torch, shape, torch.bfloat16)
        prepared = kmb.prepare_inverted_residual(*args[1:], rate=rate, elem_size=2)
        cfg = prepared.config
        ms, plain_ms = ab_ms(
            lambda: kmb.fused_inverted_residual(*args, rate=rate, residual=residual,
                                                prepared=prepared),
            lambda: kmb.fused_inverted_residual_reference(*args, rate=rate, residual=residual),
            iters=20)
        unprepared_ms = event_ms(
            lambda: kmb.fused_inverted_residual(*args, rate=rate, residual=residual), 20)
        dev_us, _ = device_us(torch, lambda: kmb.fused_inverted_residual(
            *args, rate=rate, residual=residual, prepared=prepared), calls=20)
        per_sm = load_library().fused_inverted_residual_blocks_per_sm(1, cout, cfg.smem_bytes)
        weights = nbytes(*args[1:])
        flops = 2 * n * h * w * (cin * cexp + 9 * cexp + cexp * cout)
        bound_ms, bound_by = mbconv_bound(
            shape, nbytes(args[0]) + n * h * w * cout * 2 + weights)
        x = args[0].permute(0, 3, 1, 2)

        def run(fused):
            block.fused_inference = fused
            with torch.inference_mode():
                return block(x)

        mod_fused, mod_plain = ab_ms(lambda: run(True), lambda: run(False), iters=20)
        block.fused_inference = True
        rate_text = ("rate not measured" if dev_us is None
                     else f"{flops / (dev_us * 1e-6) / 1e12:.2f} TFLOP/s")
        print(f"  {shape}: kernel {ms * 1e3:.1f} us (device {us_text(dev_us, 1)}, "
              f"{rate_text}; {cfg.smem_bytes} B shared, "
              f"{per_sm} block(s) an SM, chunk {cfg.chunk} x {cfg.stages} buffers), bound "
              f"{bound_ms * 1e3:.1f} us by {bound_by}, plain {plain_ms * 1e3:.1f} us, preparing "
              f"on the fly {unprepared_ms * 1e3:.1f} us; module fused {mod_fused * 1e3:.1f} us, "
              f"standard {mod_plain * 1e3:.1f} us")
        rows.append({"shape": list(shape), "ms": ms,
                     "device_ms": None if dev_us is None else dev_us * 1e-3,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "unprepared_ms": unprepared_ms, "blocks_per_sm": per_sm,
                     "module_fused_ms": mod_fused, "module_standard_ms": mod_plain})
        del args, x
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms",
                                                  "unprepared_ms", "module_fused_ms",
                                                  "module_standard_ms")}
    # the device total only where every shape's trace gave a time
    total["device_ms"] = (None if any(r["device_ms"] is None for r in rows)
                          else sum(r["device_ms"] for r in rows))
    device_total = None if total["device_ms"] is None else total["device_ms"] * 1e3
    print(f"  the 13 calls: kernel {total['ms'] * 1e3:.1f} us (device "
          f"{us_text(device_total, 1)}), bound {total['bound_ms'] * 1e3:.1f} us, plain "
          f"{total['plain_ms'] * 1e3:.1f} us, preparing on the fly "
          f"{total['unprepared_ms'] * 1e3:.1f} us; modules fused "
          f"{total['module_fused_ms'] * 1e3:.1f} us, standard "
          f"{total['module_standard_ms'] * 1e3:.1f} us")
    by = {r["bound_by"] for r in rows}
    return {"name": "fused_inverted_residual", "route": "cuda",
            "source": "deeplabv3p_torch/ops/kernels/csrc/mbconv.cu",
            "replaces": "deeplabv3p_tpu/ops/pallas/mbconv.py:136",
            "launches": launches["fused_inverted_residual"],
            "max_abs_err": rec["max_abs_err"], "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": by.pop() if len(by) == 1 else "operations", "library_ms": None,
            "device_ms": total["device_ms"], "unprepared_ms": total["unprepared_ms"],
            "module_fused_ms": total["module_fused_ms"],
            "module_standard_ms": total["module_standard_ms"], "per_shape": rows}


if __name__ == "__main__":
    main()
