"""CRF parity study against the exact dense mean-field oracle (the port of
tools/misc/crf_parity_study.py: the same sweep, regimes and columns).

The ground truth is `postprocess.crf_exact_dense`, the O(N^2) dense mean
field that pydensecrf's permutohedral lattice and `crf_inference`'s
bilateral grid both approximate. The example/ pairs, downscaled so that the
(N, N) kernels fit, go through

  * the exact oracle with pydensecrf's RGB bilateral features,
  * the exact oracle with BT.601 LUMA features (the luma-projection error
    that the grid's luma mode accepts), and
  * `crf_inference`'s grid over a (space_step x n_bins) sweep,

and each (pair, regime) prints a table:
  agree_all   : share of pixels where the grid's argmax is the oracle's
  agree_delta : the same on the pixels the ORACLE changed from the input
                mask (the pixels the CRF is for)
  q_mae       : mean |Q_grid - Q_oracle|
  vs_luma     : the grid's argmax against the luma oracle's

Two parameter regimes a pair: `reference` (sxy 3/80, srgb 13, 5 iterations
at the downscaled size, near-global spatial coupling) and `scaled`
(sxy_bilateral scaled by the downscale factor: the 512 px deployment's
sigma-to-image ratio).

    python -m deeplabv3p_torch.tools.crf_parity_study --size 128          # on the card
    python -m deeplabv3p_torch.tools.crf_parity_study --size 24 --device cpu

On the card the oracle runs in f64 there: at --size 128 (N = 128 x 170) its
two kernels take ~7.6 GB.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "example")
STEMS = ("2007_000039", "2007_000346")


def load_pair(stem: str, h: int, w: int):
    """(image (h, w, 3) f32 0..255, label mask (h, w) uint8) of an example/
    pair, resized bilinear / nearest."""
    from PIL import Image

    img = Image.open(os.path.join(EXAMPLE, f"{stem}.jpg")).resize((w, h), Image.BILINEAR)
    lbl = Image.open(os.path.join(EXAMPLE, f"{stem}.png")).resize((w, h), Image.NEAREST)
    return np.asarray(img, np.float32), np.asarray(lbl)


def compact(mask: np.ndarray):
    colors, inv = np.unique(mask, return_inverse=True)
    return inv.reshape(mask.shape).astype(np.int32), len(colors)


def agreement(a, b, sel=None) -> float:
    if sel is not None:
        if not sel.any():
            return float("nan")
        a, b = a[sel], b[sel]
    return float((a == b).mean())


def sweep(features: str):
    """(space_step, n_bins) pairs; rgb composite grids grow as n_bins**3, so
    their per-channel bins stop at 16."""
    bin_sweep = (4, 8, 16, 32) if features == "luma" else (4, 8, 16)
    return [(ss, nb) for ss in (4, 8, 16, 32) for nb in bin_sweep]


def main(argv=None) -> list[dict]:
    """Run the study; print the tables and return their rows."""
    from deeplabv3p_torch import postprocess as pp

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=128, help="downscaled height (width keeps 4:3)")
    ap.add_argument("--features", choices=("rgb", "luma"), default="rgb",
                    help="the grid's colour space to sweep: rgb is the default mode "
                         "(composite n_bins**3 grid), luma the fast path")
    ap.add_argument("--stems", nargs="+", default=list(STEMS), help="example/ pairs to run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the oracle and the grid run; cuda needs a card")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and torch.cuda.is_available() "
                           "is False; pass --device cpu to run the study on the CPU")
    device = torch.device(args.device)

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    h = args.size
    w = h * 4 // 3
    rows = []
    for stem in args.stems:
        image_np, mask = load_pair(stem, h, w)
        labels, n_labels = compact(mask)
        image = torch.from_numpy(image_np).to(device)
        unary = pp.unary_from_labels(torch.from_numpy(labels).to(device), n_labels)
        scale = 500.0 / w  # the example/ images are 500 wide
        for regime, sxy_b in (("reference", 80.0), ("scaled", 80.0 / scale)):
            params = dict(n_iters=5, sxy_gaussian=3.0, compat_gaussian=3.0,
                          sxy_bilateral=sxy_b, srgb_bilateral=13.0, compat_bilateral=10.0)
            t0 = synced()
            q_rgb = pp.crf_exact_dense(unary, image, **params)
            q_luma = pp.crf_exact_dense(unary, image, bilateral_features="luma", **params)
            t_oracle = synced() - t0
            m_rgb = q_rgb.argmax(-1).cpu().numpy()
            m_luma = q_luma.argmax(-1).cpu().numpy()
            delta = m_rgb != labels  # the pixels the oracle changed
            print(f"\n== {stem} {h}x{w} regime={regime} features={args.features} "
                  f"(sxy_b={sxy_b:.1f}, oracle {t_oracle:.1f}s on {args.device}, "
                  f"oracle changed {delta.mean():.2%} of pixels)")
            print(f"   luma-oracle vs rgb-oracle: agree_all={agreement(m_luma, m_rgb):.4f} "
                  f"agree_delta={agreement(m_luma, m_rgb, delta):.4f}")
            print(f"   {'step':>4} {'bins':>4} {'agree_all':>9} {'agree_delta':>11} "
                  f"{'q_mae':>8} {'vs_luma':>8}")
            for ss, nb in sweep(args.features):
                if ss >= h // 2:
                    continue
                q_g = pp.crf_inference(unary, image, space_step=ss, n_bins=nb,
                                       color_features=args.features, **params)
                m_g = q_g.argmax(-1).cpu().numpy()
                row = dict(stem=stem, regime=regime, step=ss, bins=nb,
                           agree_all=agreement(m_g, m_rgb),
                           agree_delta=agreement(m_g, m_rgb, delta),
                           q_mae=float((q_g - q_rgb).abs().mean()),
                           vs_luma=agreement(m_g, m_luma))
                rows.append(row)
                print(f"   {ss:>4} {nb:>4} {row['agree_all']:>9.4f} {row['agree_delta']:>11.4f} "
                      f"{row['q_mae']:>8.5f} {row['vs_luma']:>8.4f}")
            del q_rgb, q_luma
    return rows


if __name__ == "__main__":
    main()
