"""Copy of deeplabv3p_tpu/data/toy.py (the tiny on-disk overfit dataset),
pinned equal to it by tests/test_torch_train.py. numpy and PIL only, so
the port reads and writes the same files without importing JAX.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

# default source pairs vendored under tests/fixtures + repo example/
EXAMPLE_IDS = ("2007_000039", "2007_000346")

# VOC classes present in the example pairs, remapped to a compact index
# set (mIoU is a plain mean over ALL classes after NaN→0, reference
# eval.py:461-506 — absent classes would otherwise pin mIoU near 4/21)
CLASS_REMAP = {0: 0, 5: 1, 15: 2, 20: 3, 255: 255}
CLASS_NAMES = ("background", "bottle", "person", "tvmonitor")


def _gamma(image: np.ndarray, g: float) -> np.ndarray:
    lut = (np.power(np.arange(256, dtype=np.float32) / 255.0, g) * 255.0)
    return lut.astype(np.uint8)[image]


# (suffix, image transform, joint flip?) — label-safe variants only:
# photometric ops touch the image alone; flips move image+label together.
_VARIANTS = (
    ("orig", lambda im: im, False),
    ("hflip", lambda im: im[:, ::-1], True),
    ("g08", lambda im: _gamma(im, 0.8), False),
    ("g12h", lambda im: _gamma(im, 1.25)[:, ::-1], True),
)


def build_overfit_dataset(
    out_dir: str,
    source_dir: str = "example",
    ids: tuple[str, ...] = EXAMPLE_IDS,
    n_variants: int = 4,
) -> str:
    """Create the dataset under `out_dir`; returns the list-file path.

    n_variants selects a prefix of (orig, hflip, gamma0.8, gamma1.25+hflip)
    per source pair — n_variants=4 gives 8 samples from the 2 pairs.
    """
    img_dir = os.path.join(out_dir, "images")
    lbl_dir = os.path.join(out_dir, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    remap = np.full(256, 255, np.uint8)
    for src, dst in CLASS_REMAP.items():
        remap[src] = dst
    with open(os.path.join(out_dir, "classes.txt"), "w") as f:
        f.write("\n".join(CLASS_NAMES) + "\n")
    names = []
    for sid in ids:
        image = np.array(
            Image.open(os.path.join(source_dir, sid + ".jpg")).convert("RGB")
        )
        label = remap[
            np.array(Image.open(os.path.join(source_dir, sid + ".png")))
        ]
        for suffix, fn, flip in _VARIANTS[:n_variants]:
            name = f"{sid}_{suffix}"
            im = fn(image)
            lb = label[:, ::-1] if flip else label
            Image.fromarray(im).save(
                os.path.join(img_dir, name + ".jpg"), quality=95
            )
            Image.fromarray(lb).save(os.path.join(lbl_dir, name + ".png"))
            names.append(name)
    list_path = os.path.join(out_dir, "list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path
