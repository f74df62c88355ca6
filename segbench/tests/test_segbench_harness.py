"""The import rules, the arithmetic the per-layer metrics use, and the
result's line."""

from __future__ import annotations

import ast
import json
import math
import sys
from types import SimpleNamespace

import pytest
import torch

from segbench import flops, harness, roofline
from segbench.reference.deeplab import MNV2_BLOCKS, make_divisible, strides_and_rates
from segbench.trace import TraceContext, breakdown


def imported_names(path) -> set[str]:
    """Top-level module names a file imports (the part before the first dot)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(harness.HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported_names(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert "deeplabv3p_torch" not in imported_names(path), path
        assert "deeplabv3p_torch" not in path.read_text(), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deeplabv3p_torch_like", SimpleNamespace())
    assert "deeplabv3p_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "deeplabv3p_tpu.models", SimpleNamespace())
    assert harness.forbidden_modules() == ["deeplabv3p_tpu"]


def mobilenetv2_forward_flops(h: int, w: int, classes: int, output_stride: int) -> float:
    """DeepLabV3+ MobileNetV2's conv FLOPs by hand: 2 x k x k x Cin x Cout x
    Hout x Wout a dense conv, 2 x k x k x C x Hout x Wout a depthwise one."""
    total = 0.0

    def dense(k, cin, cout, hw):
        return 2.0 * k * k * cin * cout * hw[0] * hw[1]

    def dw(c, hw):
        return 2.0 * 9 * c * hw[0] * hw[1]

    def down(hw, s):
        return (-(-hw[0] // s), -(-hw[1] // s))

    tab = strides_and_rates(output_stride)
    hw = down((h, w), 2)
    total += dense(3, 3, 32, hw)
    ch, skip_hw = 32, None
    for i, (filters, stride, expansion, _, _) in enumerate(MNV2_BLOCKS):
        stride = tab.get(stride, stride)
        mid = ch * expansion if i else ch
        if i:
            total += dense(1, ch, mid, hw)
        hw = down(hw, stride)
        total += dw(mid, hw) + dense(1, mid, make_divisible(filters), hw)
        ch = make_divisible(filters)
        if i == 2:
            skip_hw = hw
    total += dense(1, ch, 256, (1, 1)) + dense(1, ch, 256, hw)  # pooling and 1x1
    total += 3 * (dw(ch, hw) + dense(1, ch, 256, hw)) + dense(1, 5 * 256, 256, hw)
    total += dense(1, 24, 48, skip_hw) + dw(304, skip_hw) + dense(1, 304, 256, skip_hw)
    total += dw(256, skip_hw) + dense(1, 256, 256, skip_hw) + dense(1, 256, classes, skip_hw)
    return total


def test_flops_against_a_hand_count():
    cfg = {"model_type": "mobilenetv2", "output_stride": 16, "num_classes": 21,
           "input_hw": [128, 96]}
    want = mobilenetv2_forward_flops(128, 96, 21, 16)
    assert flops.conv_flops(cfg, 1, train=False) == pytest.approx(want, rel=1e-12)
    assert flops.conv_flops(cfg, 3, train=False) == pytest.approx(3 * want, rel=1e-12)
    # the backward's two gradients are as much again each, but the first
    # conv's input gradient, which nothing needs
    first = 2.0 * 9 * 3 * 32 * 64 * 48
    assert flops.conv_flops(cfg, 1, train=True) == pytest.approx(3 * want - first, rel=1e-12)


def test_rooflines_against_hand_counts():
    assert roofline.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 67e12) == pytest.approx(1.0)
    fwd, bwd = roofline.upsample_ce_s(16, 128, 128, 21, 512, 512)
    logits, px = 4 * 16 * 128 * 128 * 21, 16 * 512 * 512
    assert fwd == pytest.approx(max((logits + 16 * px) / 3.35e12, 10 * 21 * px / 67e12))
    assert bwd == pytest.approx(max((2 * logits + 12 * px) / 3.35e12, 18 * 21 * px / 67e12))
    assert roofline.confusion_s(32, 512, 512, 21, 4, 4) == pytest.approx(
        max((32 * 512 * 512 * 88 + 8 * 441) / 3.35e12, 32 * 512 * 512 * 21 / 67e12))


def fake_event(name, start, end, children=(), seq=-1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(
        start=start, end=end, elapsed_us=lambda: end - start), cpu_children=list(children),
        sequence_nr=seq, device_time_total=0.0)


def test_busy_idle_and_breakdown():
    device = [fake_event("k1", 0, 10), fake_event("k2", 5, 20), fake_event("k3", 50, 60)]
    host = [fake_event("aten::conv", 20, 50)]
    ctx = TraceContext(cell={"batch": 1}, config={}, units=2, window_us=100.0, events=host,
                       device=device, counts={"clean_units": 4, "clean_s": 200e-6})
    assert ctx.busy_us() == 30.0
    assert ctx.mean_us("k") == pytest.approx(35 / 3)
    b = breakdown(ctx)
    assert b["device_ops"][0] == ["k2", pytest.approx(15e-6)]
    assert b["idle_gaps"] == [["aten::conv", pytest.approx(30e-6)]]
    # 30 us busy over 2 units, against 50 us a unit once the profiler closed
    idle = harness.load_module("metrics", "idle_share.train")
    assert idle.read(ctx) == pytest.approx(70.0)
    assert idle.read(TraceContext(cell={}, config={}, units=2, window_us=100.0, events=host,
                                  device=device)) is None


def worst_line() -> str:
    """The longest last line a run can print: every per-layer metric of the
    manifest, ten device operations and ten gaps under 120-character names,
    and every check."""
    metrics = {m["name"]: {"value": -1.2345678901234567e-300, "unit": m["unit"]}
               for m in harness.manifest()["per_layer"]}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 85899345920, "busy_s": 1.2345678901234567,
              "window_s": 1.2345678901234567}
    names = ["x" * 120] * 10
    b = {"device_ops": [[n, 1.2345678901234567e-05] for n in names],
         "idle_gaps": [[n, 1.2345678901234567e-05] for n in names]}
    checks = [harness.Check(f"check_number_{i}", math.inf, 1.2345678901234567e-05)
              for i in range(8)]
    return harness.result_line(False, 10 ** 9, 10 ** 9, metrics, device, checks, b)


def test_result_line_keys_and_worst_length():
    line = worst_line()
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert "\n" not in line and len(line) < 8000
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())


def test_breakdown_names_are_cut():
    long_name = "void kernel<" + "T" * 500 + ">()"
    ctx = TraceContext(cell={}, config={}, units=1, window_us=10.0,
                       events=[], device=[fake_event(long_name, 0, 1)])
    assert len(breakdown(ctx)["device_ops"][0][0]) <= 120


def test_checks():
    assert harness.Check("a", 0.5, 1.0).ok and not harness.Check("a", 2.0, 1.0).ok
    assert not harness.Check("a", math.nan, 1.0).ok and not harness.Check("a", math.inf, 1.0).ok
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    keep = harness.moved_leaves(ref)
    assert keep == {"a", "b"}
    assert harness.leaf_gaps({"a": 1.1, "b": 2.0, "c": 5.0}, ref, keep) == pytest.approx(
        [0.0, 0.05])
    assert harness.leaf_gaps({"a": 1.0}, ref, keep) == [math.inf]
    assert math.isfinite(harness.finite(math.inf))
