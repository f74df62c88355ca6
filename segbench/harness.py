"""What every cell shares: finding a cell's files by name, the measured
window, the comparison that decides `correct`, and the result's line.

A cell `<name>` is `workloads/<name>.json`; its configuration `<config>` is
`configs/<config>.json`; its traffic `<traffic>` is the module
`traffic/<traffic>.py`, whose `Traffic` class the harness drives; a
per-layer metric `<metric>` is `metrics/<metric>.py`, whose `read(ctx)`
returns its value or None. BENCHMARK.json at the checkout's root says
which metrics a cell reports. A later cell, configuration, traffic mix or
metric is a new file of its own.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deeplabv3p_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> tuple[dict, dict]:
    """(the cell's file, its configuration's file), each with its name."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload {name!r}: {path} is missing")
    c = read_json(path)
    cfg = read_json(HERE / "configs" / f"{c['config']}.json")
    return dict(c, name=name), cfg


def load_module(kind: str, name: str):
    """`segbench/<kind>/<name>.py` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"segbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(m: dict, name: str, traced: bool) -> list[dict]:
    """The manifest's metrics that cell `name` reports: its end-to-end ones,
    or with `traced` its per-layer ones."""
    end_to_end = [e for e in m["end_to_end"] if name in e.get("workloads", [name])]
    if not traced:
        return end_to_end
    moved = {e["name"] for e in end_to_end}
    return [e for e in m["per_layer"]
            if (name in e["workloads"] if "workloads" in e else e["moves"] in moved)]


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that must not be loaded, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


SEEDED_WEIGHTS = "seeded_weights"  # the set-up phase that `setup_s` leaves out


class Phases:
    """Seconds of each part of a set-up, the device drained at each mark.
    The phase `SEEDED_WEIGHTS`, the benchmark's making of the weights (its
    draws and the reference's calibrating forward), is timed but not part
    of `setup_s`, as the reference's own time is not."""

    def __init__(self, device):
        self.device, self.seconds, self._t = device, {}, time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def warm_libraries(device) -> None:
    """Load cuDNN and cuBLAS with a tiny convolution and product in bf16 and
    f32, so that a user's set-up pays their loading in `setup_s` and not in
    the left-out making of the weights, whose reference forward calls them
    first."""
    import torch

    for dtype in (torch.bfloat16, torch.float32):
        x = torch.ones((1, 8, 8, 8), dtype=dtype, device=device)
        torch.nn.functional.conv2d(x, torch.ones((8, 8, 3, 3), dtype=dtype, device=device))
        x.view(8, 64) @ x.view(64, 8)


@dataclass
class Check:
    """One number the comparison reads, with its limit: the run is correct
    when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel_gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def leaf_gaps(program: dict, reference: dict, keep: set) -> list[float]:
    """Each leaf's gap between the two sides' norms, over the larger of the
    reference's norm of that leaf and of the median leaf, among `keep`,
    sorted; [inf] where the two sides do not name the same leaves."""
    if set(program) != set(reference) or not keep:
        return [math.inf]
    norms = sorted(reference[k] for k in keep)
    median = norms[len(norms) // 2]
    return sorted(rel_gap(program[k], reference[k], max(reference[k], median)) for k in keep)


def moved_leaves(g1: dict) -> set:
    """Leaves whose first gradient in the reference is at least a thousandth
    of the median leaf's: the others move by rounding alone."""
    norms = sorted(g1.values())
    median = norms[len(norms) // 2]
    return {k for k, v in g1.items() if v >= 1e-3 * median}


def run_window(traffic, seconds: float, tracer) -> tuple[int, float, int, float]:
    """Units until `seconds` have gone by, then the device drained: (units,
    seconds taken, and of those the units and seconds after the profiler
    closed, which neither it nor the traffic's spans, taken out then,
    slowed)."""
    traffic.window_begin()
    t0 = time.perf_counter()
    n, clean_from, clean_t0 = 0, 0, t0
    while True:
        with tracer.around(n):
            traffic.unit()
        n += 1
        if tracer.enabled and tracer.done and clean_from == 0:
            traffic.uninstrument()
            clean_from, clean_t0 = n, time.perf_counter()
        if time.perf_counter() - t0 >= seconds and (not tracer.enabled or tracer.done):
            break
    traffic.window_end()
    t1 = time.perf_counter()
    return n, t1 - t0, n - clean_from, t1 - clean_t0


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list[Check], breakdown=None) -> str:
    """The run's last line: the driver's keys, then `checks`, each compared
    number beside its limit."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": finite(c.value), "limit": c.limit} for c in checks}
    return json.dumps(out, allow_nan=False)


def finite(v: float) -> float:
    """A non-finite reading as the largest double, so the line stays JSON."""
    return v if math.isfinite(v) else 1.7976931348623157e308
