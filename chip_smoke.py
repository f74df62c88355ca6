#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeplabv3p_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one GPU

1. prints the card (`nvidia-smi` name and power limit) and the versions;
2. builds the CUDA kernels from deeplabv3p_torch/ops/kernels/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at ragged ones, in f32 and bf16, with TF32 off;
4. serves 8 requests through `DeepLab` (mobilenetv2, full ASPP + decoder
   head, 512x512, OS16, 21 VOC classes, bf16, seeded weights) as built by
   default (fused ASPP kernel), then 8 more with the fused decoder kernel
   too, and checks that each kernel's launch count rose by one a request;
5. checks the masks and logits against the same weights in f32 with both
   kernels off, and prints per-request latency, a device-time profile of
   one request, and each kernel's time against its plain version.

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
        from deeplabv3p_torch.postprocess import mask_argmax
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
    check(after_first == {"multirate_atrous_depthwise": N_REQUESTS, "fused_decoder_frontend": 0},
          f"default DeepLab: launch counts {after_first} (ASPP one a request, decoder none)")
    check(launches == {"multirate_atrous_depthwise": 2 * N_REQUESTS,
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
    dispatch time that CUDA events around short calls also take in."""
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
    from torch.profiler import ProfilerActivity, profile

    data, hw = request
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):  # the first window pays the tracer's start-up; keep the second
        deeplab.predict(data, hw)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            deeplab.predict(data, hw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()
    rows = sorted(((e.device_time_total, e.count, e.key) for e in events
                   if e.device_time_total > 0 and e.device_type.name == "CUDA"), reverse=True)
    if not rows:
        print("profile: torch.profiler recorded no device time")
        return
    busy_us = sum(r[0] for r in rows)
    print(f"profile of one served request: {sum(r[1] for r in rows)} device operations "
          f"(kernels and copies), device busy {busy_us:.1f} us of {wall_us:.1f} us wall "
          f"under the profiler (idle share {1 - busy_us / wall_us:.3f}); top by device time:")
    for total, count, key in rows[:12]:
        print(f"  {total:9.1f} us  {count:4d}x  {key[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_one_request.txt"), "w") as f:
        f.write(events.table(sort_by="device_time_total", row_limit=60))


if __name__ == "__main__":
    main()
