"""One run of one cell of the port's benchmark.

    python3 -m segbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (`segbench/workloads/<cell>.json`) and its configuration,
makes the weights and inputs from the seed, builds the program
(`deeplabv3p_torch`) and warms up the cell's own shapes (all of it
`setup_s` but the making of the weights, the benchmark's own work),
measures for `--seconds`, then frees the program and checks
what the window produced against the plain reference
(`segbench/reference/`). The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device` and, traced,
`breakdown`; its last key, `checks`, holds each compared number beside its
limit, and so do the last lines of standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from segbench import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line(torch) -> str:
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(0)} (power limit not read)"


def measure(m: dict, cell: dict, cfg: dict, seed: int, seconds: float, traced: bool,
            device, prepare=None) -> dict | None:
    """Set up, measure, free and check one run of `cell` on `device`: the
    result's fields and `checks`, or None when the run loaded a forbidden
    module. `prepare(traffic)` is called before the set-up (a test breaks
    the timed path with it)."""
    import torch

    from segbench.trace import Tracer, breakdown, context

    cuda = device.type == "cuda"
    traffic = harness.load_module("traffic", cell["traffic"]).Traffic(cell, cfg, seed, device)
    if prepare is not None:
        prepare(traffic)
    traffic.setup()
    if cuda:
        torch.cuda.synchronize()
    left_out = traffic.phases.seconds.get(harness.SEEDED_WEIGHTS, 0.0)
    setup_s = time.perf_counter() - START - left_out
    parts = ", ".join(f"{k} {v:.3f}" for k, v in traffic.phases.seconds.items())
    say(f"segbench: set-up {setup_s:.3f} s, {harness.SEEDED_WEIGHTS} left out ({parts} s)")

    if traced:
        traffic.instrument()
    tracer = Tracer(traced, first=1, units=cell["trace_units"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    units, window_s, clean_units, clean_s = harness.run_window(traffic, seconds, tracer)
    peak = max(traffic.setup_peak_bytes, torch.cuda.max_memory_allocated() if cuda else 0)
    loaded = harness.forbidden_modules()
    if loaded:
        say(f"segbench: the run loaded {', '.join(loaded)}: no result")
        return None
    say(f"segbench: window {window_s:.3f} s, {units} {traffic.unit_name}(s)")

    metrics, device_extra, trace_breakdown = {}, {}, None
    wanted = harness.metrics_of(m, cell["name"], traced)
    if traced:
        counts = dict(traffic.trace_counts(), clean_units=clean_units, clean_s=clean_s)
        ctx = context(tracer.prof, cell, cfg, cell["trace_units"], counts)
        tracer.prof = None
        device_extra = {"busy_s": ctx.busy_us() * 1e-6, "window_s": ctx.window_us * 1e-6}
        for spec in wanted:
            value = harness.load_module("metrics", spec["name"]).read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        trace_breakdown = breakdown(ctx)
        del ctx
    else:
        values = dict(traffic.end_to_end(units, window_s), setup_s=setup_s)
        for spec in wanted:
            metrics[spec["name"]] = {"value": values[spec["name"]], "unit": spec["unit"]}

    attempted, failed = traffic.attempted, traffic.failed
    traffic.release()
    checks = traffic.check()
    loaded = harness.forbidden_modules()
    if loaded:
        say(f"segbench: the run loaded {', '.join(loaded)}: no result")
        return None
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(0) if cuda else device.type,
            "count": cell["chips"], "memory_peak_bytes": int(peak), **device_extra}
    return {"correct": failed == 0 and all(c.ok for c in checks), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": info, "checks": checks,
            "breakdown": trace_breakdown, "info": traffic.info}


def main(argv=None) -> int:
    args = parse_args(argv)
    m = harness.manifest()
    cell, cfg = harness.cell(args.workload)
    build = harness.ROOT / "build" / "segbench"
    # every cache the program could fill lives at a fixed place in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # one host thread for torch's CPU work: idle OpenMP workers spinning after
    # each small CPU operation took host time from the timed path (PERF.md)
    os.environ["OMP_NUM_THREADS"] = "1"

    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        say(f"segbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} card(s): no result")
        return 2
    say(f"segbench: {cell['name']} seed {args.seed} on {card_line(torch)}, "
        f"torch {torch.__version__}")
    out = measure(m, cell, cfg, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda"))
    if out is None:
        return 3
    checks = out.pop("checks")
    for name, value in out.pop("info").items():
        say(f"info {name}: {value!r}")
    for c in checks:
        say(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}")
    print(harness.result_line(checks=checks, **out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
