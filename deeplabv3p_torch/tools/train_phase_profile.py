"""Train-step phase / roofline decomposition on the card.

The port's copy of tools/evaluation/train_phase_profile.py: where do the
milliseconds of a training step go, and which roofline binds each phase?
A DeepLabV3+ model in bf16 (f32 parameters, as the trainer runs it), a
seeded batch, and six phases, each timed alone:

  backbone_fwd    the backbone's forward only (features + skip), eval mode
  forward         the full model forward (head + logits upsample), eval mode
  forward+loss    the trainer's forward and loss (train-mode BN, CE, L2),
                  no gradient
  grad (fwd+bwd)  the same with the gradient of every parameter
  train_step      the real step: `Trainer.make_train_step` over
                  `build_stage_state` (SGD 1e-3, cosine decay, freeze level
                  0): gradient, optimizer, BN statistics, metrics
  loss_only       CE on the forward's full-resolution logits

For each: the median ms of `--iters` calls after 2 warm-up calls (CUDA
events around each call on the card, `time.perf_counter` on the CPU); the
achieved TFLOP/s and its share of the card's dense bf16 peak; the
achieved GB/s and its share of the card's memory rate; and the deltas
between nested phases (head = forward - backbone, ...). A card that is
not in `utils.card.PEAKS`, and the CPU, get null shares.

What the counts count (they are not XLA's): FLOPs are
`torch.utils.flop_counter.FlopCounterMode`'s over one call of the phase,
its backward included, which counts the multiply-adds of convolutions and
matrix products (2 operations each) and no element-wise work, so
`loss_only` has none; a convolution's backward counts the forward's
multiply-adds for each gradient it computes (torch's own formula counts a
depthwise conv's weight gradient C times over). The JAX tool reads XLA's
cost analysis, which counts element-wise work too. Bytes are every ATen op's tensor inputs read plus
its outputs written, over one call (`ByteCounter`), with views and
allocations counted 0: what eager mode moves op by op, an upper bound on
what the memory carries (a cache hit is counted as a read). XLA counts
after fusion.

The phases leave the model as they found it: its parameters and BN
statistics are restored after each, and the gradients are taken with
`torch.autograd.grad`, so nothing accumulates in `.grad`.

Usage:
  python -m deeplabv3p_torch.tools.train_phase_profile \\
      --model_type=mobilenetv2_lite --batch=16 [--model_input_shape=512] [--device cpu]

The last line of the output is one JSON object: the phases and deltas,
or `{"model_type": ..., "error": ...}` with exit code 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import tempfile
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from deeplabv3p_torch.utils.card import card_peaks, card_text

WARMUP = 2


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class ByteCounter(TorchDispatchMode):
    """Bytes the ATen ops in the block read and write: each op's tensor
    arguments plus its tensor outputs, views and allocations 0."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.__name__.startswith("empty")):
            self.bytes += sum(map(_nbytes, tree_leaves((args, kwargs or {}))))
            self.bytes += sum(map(_nbytes, tree_leaves(out)))
        return out


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """A convolution's backward: each gradient asked for (input, weight)
    costs the forward's multiply-adds. torch's own formula counts the weight
    gradient of a grouped convolution as a dense one's (C times a depthwise
    conv's)."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def count_flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(
        display=False,
        custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flop})
    with counter:
        fn()
    return counter.get_total_flops()


def count_bytes(fn) -> int:
    counter = ByteCounter()
    with counter:
        fn()
    return counter.bytes


def median_ms(fn, iters: int, device: torch.device) -> float:
    """Median ms of `iters` calls after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize(device)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in events)


@contextlib.contextmanager
def kept_state(model):
    """The model's parameters and buffers as they were, after the block."""
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(saved[k])


def build_phase_model(model_type: str, num_classes: int, device):
    """The bf16 DeepLabV3+ model with seeded weights (flax's BN init)."""
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters

    model = build_deeplab_model(model_type, num_classes, output_stride=16,
                                dtype=torch.bfloat16, device=device)
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    return model


def phase_batch(batch, hw, num_classes, device):
    """The seeded (images NHWC, labels, weights) that every phase runs on."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, hw, hw, 3), generator=gen).to(device)
    labels = torch.randint(0, num_classes, (batch, hw, hw), generator=gen,
                           dtype=torch.int32).to(device)
    return x, labels, torch.ones((batch, hw, hw), device=device)


def phase_train_step(model, num_classes, loss_fn, device, log_dir):
    """(state, step) of the real train step that the train_step phase times:
    SGD at 1e-3, cosine decay over 1000 steps, freeze level 0."""
    from deeplabv3p_torch.train import StageConfig, Trainer

    trainer = Trainer(model, num_classes, loss_fn, device=device, log_dir=log_dir)
    stage = StageConfig(freeze_level=0, optim_type="sgd", learning_rate=1e-3,
                        decay_type="cosine", decay_steps=1000)
    return trainer.build_stage_state(stage), trainer.make_train_step(stage)


def profile(model_type, batch, hw, num_classes, iters, device="cuda"):
    """(rows, deltas) of the six phases of `build_phase_model`'s model."""
    from deeplabv3p_torch import losses as losses_lib
    from deeplabv3p_torch.eval import resolve_device
    from deeplabv3p_torch.models.layers import channels_last

    device = resolve_device(str(device))
    peak_flops, peak_bw = card_peaks(device)
    peaks = ("no peaks known" if peak_flops is None else
             f"peak {peak_flops / 1e12:.0f} TFLOP/s bf16, {peak_bw / 1e9:.0f} GB/s")
    card = card_text(device.index or 0) if device.type == "cuda" else "cpu"
    print(f"# device: {card}  {peaks}", file=sys.stderr)

    model = build_phase_model(model_type, num_classes, device)
    x, labels, weights = phase_batch(batch, hw, num_classes, device)
    loss_fn = losses_lib.get_loss_fn("crossentropy")
    images = x.permute(0, 3, 1, 2)

    rows = []

    def timed(name, fn):
        with kept_state(model):
            ms = median_ms(fn, iters, device)
            flops, nbytes = count_flops(fn), count_bytes(fn)
        tflops = flops / (ms / 1e3) / 1e12
        gbps = nbytes / (ms / 1e3) / 1e9
        rows.append({
            "phase": name, "ms": round(ms, 3), "tflops": round(tflops, 4),
            "mfu_pct": None if peak_flops is None else round(100 * tflops * 1e12 / peak_flops, 2),
            "hbm_gbps": round(gbps, 1),
            "hbm_pct": None if peak_bw is None else round(100 * gbps * 1e9 / peak_bw, 2),
        })
        print(f"# {name}: {ms:.2f} ms  {flops / 1e9:.3f} GFLOP {tflops:.2f} TF/s "
              f"({rows[-1]['mfu_pct']}% of peak)  {nbytes / 1e9:.3f} GB {gbps:.0f} GB/s "
              f"({rows[-1]['hbm_pct']}% of peak)", file=sys.stderr)

    with tempfile.TemporaryDirectory(prefix="phaseprof_") as log_dir:
        state, train_step = phase_train_step(model, num_classes, loss_fn, device, log_dir)
        params = [p for p in model.parameters() if p.requires_grad]

        # -- the backbone alone, then the whole forward, in eval mode ----------
        model.eval()

        @torch.no_grad()
        def bb_fwd():
            return model.backbone(channels_last(images.to(model.dtype)))[0]

        @torch.no_grad()
        def fwd():
            return model(images)

        timed("backbone_fwd", bb_fwd)
        timed("forward", fwd)
        logits0 = fwd().permute(0, 2, 3, 1)

        # -- the trainer's loss (train-mode BN + L2), then its gradient -------
        @torch.no_grad()
        def fwd_loss():
            return train_step.forward_loss(x, labels, weights)[0]

        def grad_step():
            loss = train_step.forward_loss(x, labels, weights)[0]
            return torch.autograd.grad(loss, params)

        timed("forward+loss", fwd_loss)
        timed("grad (fwd+bwd)", grad_step)

        # -- the real train step: gradient, SGD, BN statistics, metrics -------
        timed("train_step", lambda: train_step(state, x, labels, weights, 1.0))
        state.optimizer.zero_grad(set_to_none=True)
        model.eval()

        # -- the loss tail alone, on the full-resolution logits ---------------
        @torch.no_grad()
        def loss_only():
            return losses_lib.reduce_loss(loss_fn(labels, logits0), weights)

        timed("loss_only", loss_only)

    by = {r["phase"]: r["ms"] for r in rows}
    deltas = {
        "head_fwd_ms": round(by["forward"] - by["backbone_fwd"], 3),
        "loss_attach_ms": round(by["forward+loss"] - by["forward"], 3),
        "bwd_ms": round(by["grad (fwd+bwd)"] - by["forward+loss"], 3),
        "optimizer_metrics_ms": round(by["train_step"] - by["grad (fwd+bwd)"], 3),
    }
    return rows, deltas


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_type", default="mobilenetv2_lite")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--model_input_shape", type=int, default=512)
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    try:
        rows, deltas = profile(args.model_type, args.batch, args.model_input_shape,
                               args.num_classes, args.iters, args.device)
    except Exception as exc:  # noqa: BLE001 - reported as the last line, exit 1
        traceback.print_exc()
        print(json.dumps({"model_type": args.model_type,
                          "error": f"{type(exc).__name__}: {exc}"}))
        sys.stdout.flush()
        return 1
    print(json.dumps({"model_type": args.model_type, "batch": args.batch,
                      "input": args.model_input_shape, "phases": rows, "deltas": deltas}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
