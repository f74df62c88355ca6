#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeplabv3p_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one GPU

1. prints the card (`nvidia-smi` name and power limit) and the versions;
2. builds the CUDA kernels from deeplabv3p_torch/ops/kernels/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at ragged ones, with TF32 off: the ASPP and
   decoder kernels in f32 and bf16, the loss tail's forward and backward
   (csrc/upsample_ce.cu) at the training slice's (16,128,128,21) -> 512^2,
   the lite head's (2,32,32,21) -> 512^2 and a ragged (3,29,37,21) ->
   (116,148);
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
7. latency of the serving path, train-step time and peak memory fused and
   unfused in turns, device-time profiles of one request and one train
   step, and each kernel's time against its plain version.

Exits non-zero on any failure, and without printing a result when there is
no CUDA device or no checkout around the script. The line before the last is
the kernels' JSON record; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
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
# (B, h, w, C) -> (H, W) loss-tail cases; the first is the training slice's
UPSAMPLE_CE_CASES = [((16, 128, 128, 21), (512, 512)), ((2, 32, 32, 21), (512, 512)),
                     ((3, 29, 37, 21), (116, 148))]

failures: list[str] = []


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)


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
        from deeplabv3p_torch.ops.kernels import decoder as kdec
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
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
    records = {}

    # -- 3. ASPP kernel vs plain ---------------------------------------------
    print("multirate_atrous_depthwise (csrc/aspp.cu) vs plain:")
    for shape, rates in [((1, 32, 32, 320), (6, 12, 18)), ((2, 37, 29, 136), (12, 24, 36))]:
        for dtype in (f32, bf16):
            x, k, r, s, b = aspp_case(torch, shape, rates, dtype, seed=1)
            got = kaspp.multirate_atrous_depthwise(x, k, r, s, b)
            torch.cuda.synchronize()
            err, ref = max_err(got, kaspp.multirate_atrous_depthwise_reference(x, k, r, s, b))
            tol = tolerance(ref, dtype)
            check(err <= tol, f"aspp {shape} rates {rates} {dtype}: max|err| {err:.3g} "
                              f"<= {tol:.3g} (max|ref| {ref:.3g})")
            if shape == (1, 32, 32, 320) and dtype == f32:  # the serving path's call
                records["aspp"] = {"max_abs_err": err, "case": (x, k, r, s, b)}

    # -- 4. decoder kernel vs plain ------------------------------------------
    print("fused_decoder_frontend (csrc/decoder.cu) vs plain:")
    for enc, skip in [((1, 32, 32, 256), (1, 128, 128, 48)), ((2, 13, 11, 200), (2, 50, 41, 48))]:
        for dtype in (f32, bf16):
            args = decoder_case(torch, enc, skip, dtype, seed=2)
            got = kdec.fused_decoder_frontend(*args)
            torch.cuda.synchronize()
            err, ref = max_err(got, kdec.fused_decoder_reference(*args))
            tol = tolerance(ref, dtype)
            check(err <= tol, f"decoder {enc}+{skip} {dtype}: max|err| {err:.3g} "
                              f"<= {tol:.3g} (max|ref| {ref:.3g})")
            if enc == (1, 32, 32, 256) and dtype == bf16:  # the serving path's call
                records["decoder"] = {"max_abs_err": err, "case": args}

    # -- 4b. loss-tail kernels vs plain ----------------------------------------
    print("upsample_ce_forward / upsample_ce_backward (csrc/upsample_ce.cu) vs plain:")
    for shape, out_hw in UPSAMPLE_CE_CASES:
        rec = upsample_ce_check(torch, kce, shape, out_hw)
        if shape == UPSAMPLE_CE_CASES[0][0]:  # the training path's call
            records["upsample_ce"] = rec

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
        masks, times = [], []
        for data, hw in requests:
            torch.cuda.synchronize()
            t = time.perf_counter()
            masks.append(deeplab.predict(data, hw))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return masks, times

    kernels.reset_launch_counts()                    # the main path starts here
    masks, times = serve(served)
    after_first = kernels.launch_counts()
    masks_dec, times_dec = serve(served_dec)
    launches = kernels.launch_counts()               # ... and ends here
    no_loss = {"upsample_ce_forward": 0, "upsample_ce_backward": 0}
    check(after_first == {"multirate_atrous_depthwise": N_REQUESTS, "fused_decoder_frontend": 0,
                          **no_loss},
          f"default DeepLab: launch counts {after_first} (ASPP one a request, decoder and "
          "loss kernels none)")
    check(launches == {"multirate_atrous_depthwise": 2 * N_REQUESTS,
                       "fused_decoder_frontend": N_REQUESTS, **no_loss},
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

    kernels = []
    for key, name, fn, ref_fn, src, replaces in (
        ("aspp", "multirate_atrous_depthwise", kaspp.multirate_atrous_depthwise,
         kaspp.multirate_atrous_depthwise_reference,
         "deeplabv3p_torch/ops/kernels/csrc/aspp.cu", "deeplabv3p_tpu/ops/pallas/aspp.py:85"),
        ("decoder", "fused_decoder_frontend", kdec.fused_decoder_frontend,
         kdec.fused_decoder_reference,
         "deeplabv3p_torch/ops/kernels/csrc/decoder.cu",
         "deeplabv3p_tpu/ops/pallas/decoder.py:81"),
    ):
        args = records[key]["case"]
        ms, plain_ms = ab_ms(lambda: fn(*args), lambda: ref_fn(*args))
        dev_us, dev_launches = device_us(torch, lambda: fn(*args))
        plain_dev_us, plain_launches = device_us(torch, lambda: ref_fn(*args))
        print(f"{name}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a call "
              f"(CUDA events, mean of 2x200 calls each, serving-path shapes); device time "
              f"a call (profiler): kernel {dev_us:.2f} us in {dev_launches} launch(es), "
              f"plain {plain_dev_us:.2f} us in {plain_launches}")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": records[key]["max_abs_err"],
                        "ms": ms, "plain_ms": plain_ms})
    kernels += upsample_ce_times(torch, kce, records["upsample_ce"], train_launches)

    leaked = [m for m in ("jax", "flax", "deeplabv3p_tpu") if m in sys.modules]
    check(not leaked, f"no JAX module imported ({leaked or 'none'})")
    print(json.dumps({"kernels": kernels}))
    if failures:
        die(f"{len(failures)} check(s) failed: {failures}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


def device_us(torch, fn, calls: int = 50) -> tuple[float, float]:
    """(device time in us, device launches) a call of fn(), from the
    profiler's CUDA kernel events: what the card spends, without the host's
    dispatch time that CUDA events around short calls also take in. Some
    runs' traces miss kernels: a launch count below the call's whole
    number of kernels shows it, and the time is then short by as much."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in events) / calls,
            sum(e.count for e in events) / calls)


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
    lse = kce.upsample_ce_forward(logits, labels, wpx, out_hw)[2]
    return {"fwd_err": loss_err, "bwd_err": grad_err,
            "case": (logits, labels, wpx, tuple(out_hw), lse)}


def write_train_dataset(root: str, n: int, hw, num_classes: int, seed: int) -> str:
    """n seeded pairs <root>/images/<id>.jpg + labels/<id>.png: smooth random
    images, labels of 64-px class cells with 4-px 255 bands on their
    borders; returns the list file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    band = (np.arange(h)[:, None] % 64 < 4) | (np.arange(w)[None, :] % 64 < 4)
    names = []
    for i in range(n):
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
    list_path = write_train_dataset(root, TRAIN_IMAGES, INPUT, 21, TRAIN_SEED)
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
    kernels.reset_launch_counts()                    # the training path starts here
    t0 = time.perf_counter()
    trainer = train_main(train_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()               # ... and ends here
    steps = 2 * (TRAIN_IMAGES // TRAIN_BATCH)
    print(f"  trained {steps} steps in {wall:.1f} s wall (set-up and first-call cuDNN "
          f"tuning included); launch counts {launches}")
    check(launches == {"multirate_atrous_depthwise": 0, "fused_decoder_frontend": 0,
                       "upsample_ce_forward": steps, "upsample_ce_backward": steps},
          f"training: each loss kernel launched once a step ({steps}), ASPP and decoder "
          "kernels never")
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
    check(all(not torch.equal(stage1[k], start[k]) for k in head if k.endswith(".weight")),
          "stage 1 moved every head weight")
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
    for name, fn, plain, err, replaces in (
        ("upsample_ce_forward", lambda: kce.upsample_ce_forward(logits, labels, wpx, out_hw),
         lambda: kce.upsample_ce_reference(logits, labels, out_hw, sample_weights=wpx),
         rec["fwd_err"], "deeplabv3p_tpu/ops/pallas/upsample_ce.py:242"),
        ("upsample_ce_backward",
         lambda: kce.upsample_ce_backward(logits, labels, wpx, lse, out_hw),
         lambda: kce.upsample_ce_backward_reference(logits, labels, wpx, out_hw),
         rec["bwd_err"], "deeplabv3p_tpu/ops/pallas/upsample_ce.py:267"),
    ):
        ms, plain_ms = ab_ms(fn, plain, iters=20)
        dev_us, dev_launches = device_us(torch, fn, calls=10)
        plain_us, plain_launches = device_us(torch, plain, calls=10)
        print(f"{name}: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us a call (CUDA "
              f"events, mean of 2x20 calls each, {tuple(logits.shape)} -> {out_hw}); device "
              f"time a call (profiler): kernel {dev_us:.2f} us in {dev_launches} launch(es), "
              f"plain {plain_us:.2f} us in {plain_launches}")
        rows.append({"name": name, "route": "cuda",
                     "source": "deeplabv3p_torch/ops/kernels/csrc/upsample_ce.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return rows


if __name__ == "__main__":
    main()
