"""The training augmentation of the reference repository, in plain PyTorch.

The chain of deeplabv3p's `common/data_utils.py` as the JAX package batches
it (its `augment.py:374-389`), applied with per-sample parameters: flips,
zoom and rotation about the centre (nearest, 0 outside), GridMask (stripes
of period d, half of it dropped, rotated, on image and label), PIL's
Brightness, Color, Contrast and Sharpness blends, grayscale by the BGR2GRAY
weights applied to RGB (the reference's quirk), cv2's 5x5 Gaussian blur
(sigma 0: taps 1 4 6 4 1 / 16, reflect-101 borders) and a random crop where
the original image was larger than the input. Then [-1, 1] and the label
clamp (labels above C - 1 to 255).

`draw(generator, b, h, w)` draws every parameter in the order the
benchmark's training traffic consumes them; the program draws its own from
a generator the benchmark seeds alike, so both sides see the same
parameters without either reading the other's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CFG = dict(flip=0.5, vflip=0.5, rotate=30.0, zoom=0.2, zoom_rotate=0.3, gridmask=0.2,
           brightness=0.5, chroma=0.5, contrast=0.5, sharpness=0.5, grayscale=0.2, blur=0.5,
           crop=0.1)


def draw(g: torch.Generator, b: int, h: int, w: int) -> dict:
    """The chain's parameters for b samples of h x w, from `g` on its device."""
    kw = dict(generator=g, device=g.device)

    def u(lo=0.0, hi=1.0):
        return lo + torch.rand(b, **kw) * (hi - lo)

    def gate(prob):
        return torch.rand(b, **kw) < prob

    d = torch.randint(w // 7, w // 3, (b,), **kw)
    out = dict(grid_d=d)
    out["hflip"], out["vflip"] = gate(CFG["flip"]), gate(CFG["vflip"])
    out["zoom_rotate"] = gate(CFG["zoom_rotate"])
    out["angle"] = torch.randn(b, **kw) * CFG["rotate"]
    out["scale"] = 1.0 + torch.randn(b, **kw) * CFG["zoom"]
    out["gridmask"] = gate(CFG["gridmask"])
    out["st_h"] = (torch.rand(b, **kw) * d).long()
    out["st_w"] = (torch.rand(b, **kw) * d).long()
    out["grid_r"] = torch.randint(0, 360, (b,), **kw)
    for name in ("brightness", "chroma", "contrast", "sharpness"):
        out[name] = u(CFG[name], 1.0 / CFG[name])
    out["grayscale"], out["blur"], out["crop"] = (gate(CFG["grayscale"]), gate(CFG["blur"]),
                                                  gate(CFG["crop"]))
    out["crop_y"], out["crop_x"] = u(), u()
    return out


def _inverse_rotation(cx: float, cy: float, angle_deg, scale):
    """The map from output (x, y) to source (x, y) of a rotation by
    `angle_deg` counter-clockwise and a zoom by `scale` about (cx, cy)
    (the inverse of cv2.getRotationMatrix2D), as (b, 2, 3) f32; the angle
    is turned to radians in f32 and its cosine and sine rounded from f64."""
    a = angle_deg.float() * torch.tensor(math.pi / 180.0, dtype=torch.float32)
    c, s = torch.cos(a.double()).float(), torch.sin(a.double()).float()
    k = 1.0 / torch.as_tensor(scale, dtype=torch.float32, device=a.device)
    a00, a01, a10, a11 = k * c, -k * s, k * s, k * c
    return torch.stack([torch.stack([a00, a01, cx - (a00 * cx + a01 * cy)], -1),
                        torch.stack([a10, a11, cy - (a10 * cx + a11 * cy)], -1)], -2)


def _nearest_source(m, h: int, w: int, top: int = 0, left: int = 0):
    """Rounded source (x, y) of every output pixel of an h x w grid whose
    first row and column are `top`, `left`, under each sample's map m."""
    ys = torch.arange(top, top + h, dtype=torch.float32, device=m.device).view(1, h, 1)
    xs = torch.arange(left, left + w, dtype=torch.float32, device=m.device).view(1, 1, w)
    m = m.view(-1, 6, 1, 1)
    sx = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    sy = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    return torch.floor(sx + 0.5).long(), torch.floor(sy + 0.5).long()


def _warp(img, m):
    """img (b, h, w[, c]) sampled nearest at m's source of each pixel, 0
    outside."""
    b, h, w = img.shape[:3]
    sx, sy = _nearest_source(m, h, w)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = img[torch.arange(b, device=img.device).view(b, 1, 1), sy.clamp(0, h - 1),
              sx.clamp(0, w - 1)]
    if img.dim() == 4:
        inside = inside.unsqueeze(-1)
    return out * inside.to(out.dtype)


def _where(gate, new, old):
    return torch.where(gate.view(-1, *([1] * (old.dim() - 1))), new, old)


def _gray_l(img):
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _blend(base, img, factor):
    return (base + factor.view(-1, 1, 1, 1) * (img - base)).clamp(0.0, 255.0)


def apply(prm: dict, images_u8, labels_u8, orig_hw, num_classes: int):
    """The chain at `prm` on (b, h, w, 3) uint8 images and (b, h, w) labels:
    (images f32 in [-1, 1], labels int64 with 255 ignored)."""
    img, lab = images_u8.float(), labels_u8.long()
    b, h, w = lab.shape
    img = _where(prm["hflip"], img.flip(2), img)
    lab = _where(prm["hflip"], lab.flip(2), lab)
    img = _where(prm["vflip"], img.flip(1), img)
    lab = _where(prm["vflip"], lab.flip(1), lab)

    m = _inverse_rotation(w // 2, h // 2, prm["angle"], prm["scale"])
    img = _where(prm["zoom_rotate"], _warp(img, m), img)
    lab = _where(prm["zoom_rotate"], _warp(lab, m), lab)

    # GridMask: stripes on a square of side ceil(diagonal), rotated about its
    # centre, its middle h x w window kept where no stripe covers it
    side = math.ceil(math.sqrt(h * h + w * w))
    m = _inverse_rotation(side / 2.0, side / 2.0, prm["grid_r"].float(), 1.0)
    sx, sy = _nearest_source(m, h, w, (side - h) // 2, (side - w) // 2)
    d, sth, stw = (prm[k].view(b, 1, 1) for k in ("grid_d", "st_h", "st_w"))
    half = (d + 1) // 2
    striped = (torch.remainder(sy - sth, d) < half) | (torch.remainder(sx - stw, d) < half)
    on_square = (sx >= 0) & (sx < side) & (sy >= 0) & (sy < side)
    keep = (~(on_square & ~striped)).float()
    img = _where(prm["gridmask"], img * keep.unsqueeze(-1), img)
    lab = _where(prm["gridmask"], lab * keep.long(), lab)

    img = _blend(torch.zeros_like(img), img, prm["brightness"])
    img = _blend(_gray_l(img).unsqueeze(-1).expand_as(img), img, prm["chroma"])
    mean = torch.floor(_gray_l(img).double().mean(dim=(1, 2)) + 0.5).float()
    img = _blend(mean.view(b, 1, 1, 1).expand_as(img), img, prm["contrast"])
    smooth = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                          device=img.device) / 13.0
    nchw = img.permute(0, 3, 1, 2)
    inner = F.conv2d(nchw.reshape(b * 3, 1, h, w), smooth.view(1, 1, 3, 3))
    smoothed = nchw.clone()
    smoothed[:, :, 1:-1, 1:-1] = inner.view(b, 3, h - 2, w - 2).clamp(0.0, 255.0)
    img = _blend(smoothed.permute(0, 2, 3, 1), img, prm["sharpness"])
    gray = img[..., 0] * 0.114 + img[..., 1] * 0.587 + img[..., 2] * 0.299
    img = _where(prm["grayscale"], gray.unsqueeze(-1).expand_as(img), img)

    taps = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=img.device) / 16.0
    nchw = F.pad(img.permute(0, 3, 1, 2).reshape(b * 3, 1, h, w), (2, 2, 2, 2), mode="reflect")
    blurred = F.conv2d(nchw, torch.outer(taps, taps).view(1, 1, 5, 5)).view(b, 3, h, w)
    img = _where(prm["blur"], blurred.permute(0, 2, 3, 1).clamp(0.0, 255.0), img)

    oh, ow = orig_hw[:, 0].float(), orig_hw[:, 1].float()
    crop = prm["crop"] & (oh > h) & (ow > w)
    y0 = torch.floor(prm["crop_y"] * torch.clamp_min(oh - h, 1.0))
    x0 = torch.floor(prm["crop_x"] * torch.clamp_min(ow - w, 1.0))
    sxs, sys = w / ow, h / oh
    zero = torch.zeros_like(sxs)
    m = torch.stack([torch.stack([sxs, zero, sxs * x0], -1),
                     torch.stack([zero, sys, sys * y0], -1)], -2)
    img = _where(crop, _warp(img, m), img)
    lab = _where(crop, _warp(lab, m), lab)

    lab = torch.where(lab > num_classes - 1, torch.full_like(lab, 255), lab)
    return img / 127.5 - 1.0, lab
