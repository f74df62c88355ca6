"""Everything a run makes from its `--seed`: the weights and the samples.

`streams(seed)` splits the seed into independent streams (weights, data,
augmentation, the trainer's dropout). The weights are drawn on the card in two calls, one normal and one
uniform draw for every leaf at once, and cut into the leaves that the
reference model lists, in f32 (the parameters' type in every cell):
kernels N(0, 1 / fan_in), BatchNorm scales and variances U(0.5, 1.5), its
biases and means N(0, 0.1^2), the classifier's bias N(0, 0.01^2) (small, so
that the image and not a constant decides most pixels' class).

Samples are label maps of seeded regions over the classes (a 10 x 10 grid
of cells, each background with probability 0.4 or one of the other
classes), with a 3-pixel ignore band (255) along every region border, as
VOC draws around its objects, and images whose colour follows the label's
class plus noise, so that the augmentation and the model see structure.
"""

from __future__ import annotations

import numpy as np
import torch

from segbench.reference.deeplab import leaf_spec

STREAMS = ("weights", "data", "augment", "dropout")


def streams(seed: int) -> dict[str, int]:
    """One 32-bit seed a stream (what numpy's RandomState takes), from any
    whole number."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS), dtype=np.uint32)
    return {name: int(v) for name, v in zip(STREAMS, state)}


def weights(cfg: dict, seed: int, device, calibration: int = 4) -> dict[str, torch.Tensor]:
    """path -> f32 leaf on `device`, every leaf of `cfg`'s model. The
    BatchNorms' running statistics are then those of `calibration` seeded
    samples (the reference's forward in training mode, f32, no dropout), as
    a trained model's are its data's: with drawn statistics a random model's
    activations drift layer by layer until one class wins every pixel. The
    BatchNorm of the ASPP's image pooling (a 1x1 map, so its batch spread is
    the calibration images' alone) keeps its drawn statistics. After the
    calibration the last BatchNorm of every identity-residual branch
    (MobileNetV2's project BN in a block with a skip, Xception's middle-flow
    units) has its scale cut to a tenth, as trained residual networks keep
    their branches small: a random 40-65-layer model calibrated at unit
    scales is chaotic, and bf16's own rounding then moves half of its
    pixels (PERF.md)."""
    spec = leaf_spec(cfg)
    total = sum(int(np.prod(shape)) for _, shape, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for path, shape, kind, fan_in in spec:
        n = int(np.prod(shape))
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            out[path] = z / float(np.sqrt(fan_in))
        elif kind in ("bn_scale", "bn_scale_residual", "bn_var"):
            out[path] = 0.5 + u
        elif kind == "bias":
            out[path] = 0.01 * z
        else:  # bn_bias, bn_mean
            out[path] = 0.1 * z
    if calibration:
        from segbench.reference.deeplab import logits
        from segbench.reference.nn import Leaves
        from segbench.reference.train import full_f32

        images, _ = samples(calibration, tuple(cfg["input_hw"]), cfg["num_classes"],
                            seed ^ 0x5EED, device)
        x = torch.from_numpy(images).to(device).permute(0, 3, 1, 2).float() / 127.5 - 1.0
        p = Leaves(out, train=True, dropout=False)
        with torch.no_grad(), full_f32():
            logits(p, x, cfg)
        for site, (mean, var, n) in p.stats.items():
            # a BatchNorm over a 1x1 map (the ASPP's image pooling) would take
            # the few calibration images' spread alone: it keeps its drawn one
            if n > calibration:
                out[f"batch_stats/{site}/bn/mean"] = mean
                out[f"batch_stats/{site}/bn/var"] = var
    for path, _, kind, _ in spec:
        if kind == "bn_scale_residual":
            out[path] = 0.1 * out[path]
    return out


def jax_tree(flat: dict) -> dict:
    """{'params/a/b': t} -> {'params': {'a': {'b': t}}}, the interchange's
    layout."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *scopes, leaf = path.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def samples(n: int, hw: tuple[int, int], num_classes: int, seed: int, device,
            chunk: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """n (images uint8 (n, H, W, 3), labels uint8 (n, H, W)) on the host,
    drawn on `device` a chunk at a time."""
    h, w = hw
    g = torch.Generator(device=device).manual_seed(seed)
    palette = torch.randint(0, 256, (num_classes, 3), generator=g, device=device).float()
    images = np.empty((n, h, w, 3), np.uint8)
    labels = np.empty((n, h, w), np.uint8)
    for lo in range(0, n, chunk):
        b = min(chunk, n - lo)
        cls = torch.randint(1, num_classes, (b, 10, 10), generator=g, device=device)
        bg = torch.rand((b, 10, 10), generator=g, device=device) < 0.4
        cls = torch.where(bg, torch.zeros_like(cls), cls)
        rows = (torch.arange(h, device=device) * 10) // h
        cols = (torch.arange(w, device=device) * 10) // w
        lab = cls[:, rows][:, :, cols]
        noise = torch.rand((b, h, w, 3), generator=g, device=device) * 96.0
        img = (palette[lab] * 0.6 + noise).clamp(0, 255).to(torch.uint8)
        edge = torch.zeros_like(lab, dtype=torch.bool)
        edge[:, :-3] |= lab[:, :-3] != lab[:, 3:]
        edge[:, :, :-3] |= lab[:, :, :-3] != lab[:, :, 3:]
        lab = torch.where(edge, torch.full_like(lab, 255), lab)
        images[lo:lo + b] = img.cpu().numpy()
        labels[lo:lo + b] = lab.to(torch.uint8).cpu().numpy()
    return images, labels
