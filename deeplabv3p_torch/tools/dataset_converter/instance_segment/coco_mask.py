"""Pure-numpy COCO mask utilities + a minimal COCO-json reader.

The port's copy of tools/dataset_converter/instance_segment/coco_mask.py.
The reference's instance-segment converters depend on pycocotools
(instance_segment/coco_annotation.py:7-8), which neither the port nor the
JAX package needs. This module re-implements the small
subset actually used, from the public COCO RLE spec (the `rleToString` /
`rleFrString` scheme of the COCO maskApi): Fortran-order run-length masks
with delta + 5-bit varint string compression, polygon rasterization, and a
`MiniCOCO` index offering the pycocotools query surface
(getCatIds/getImgIds/getAnnIds/loadImgs/loadAnns/loadCats/annToMask).

No pycocotools, no cython — numpy + PIL only, so the converters run (and
are tested) anywhere.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

import numpy as np
from PIL import Image, ImageDraw


# ---------------------------------------------------------------------------
# RLE codec (COCO-compatible)
# ---------------------------------------------------------------------------

def mask_to_rle_counts(mask: np.ndarray) -> list[int]:
    """Binary (H, W) mask → COCO run lengths: column-major scan,
    alternating runs, first run counts zeros."""
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    # run boundaries
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(starts).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return [int(r) for r in runs]


def rle_counts_to_mask(counts: Iterable[int], h: int, w: int) -> np.ndarray:
    counts = list(counts)
    total = sum(counts)
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != h*w {h * w}")
    flat = np.zeros(h * w, dtype=np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def rle_counts_to_string(counts: Iterable[int]) -> str:
    """Compress run lengths to the COCO ascii string format: counts after
    the second are delta-encoded against counts[i-2], each value emitted
    as a little-endian 5-bit varint (bit 5 = continuation) offset by 48."""
    counts = [int(c) for c in counts]
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(48 + c))
    return "".join(out)


def rle_string_to_counts(s: str) -> list[int]:
    counts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x, k = 0, 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask → compressed COCO RLE dict
    (pycocotools.mask.encode equivalent, counts already a str)."""
    h, w = mask.shape
    return {
        "size": [int(h), int(w)],
        "counts": rle_counts_to_string(mask_to_rle_counts(mask)),
    }


def decode(rle: dict) -> np.ndarray:
    """COCO RLE dict (compressed str or uncompressed list counts) →
    binary (H, W) uint8 mask (pycocotools.mask.decode equivalent)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    if isinstance(counts, str):
        counts = rle_string_to_counts(counts)
    return rle_counts_to_mask(counts, h, w)


# ---------------------------------------------------------------------------
# Polygon rasterization
# ---------------------------------------------------------------------------

def polygons_to_mask(polygons: list[list[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon segmentation ([[x0,y0,x1,y1,...], ...]) → binary mask."""
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        xy = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(xy) >= 3:
            draw.polygon(xy, outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """COCO annotation dict → binary (H, W) mask, handling polygon lists,
    uncompressed RLE (counts list) and compressed RLE (counts str)."""
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    return decode(seg)


def mask_to_bbox(mask: np.ndarray) -> tuple[int, int, int, int]:
    """Binary mask → (xmin, ymin, xmax, ymax) (reference mask_to_bbox,
    voc_sbd_to_coco.py:37-53)."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    ymin, ymax = np.flatnonzero(rows)[[0, -1]]
    xmin, xmax = np.flatnonzero(cols)[[0, -1]]
    return int(xmin), int(ymin), int(xmax), int(ymax)


# ---------------------------------------------------------------------------
# Minimal COCO index
# ---------------------------------------------------------------------------

class MiniCOCO:
    """Tiny pycocotools.COCO replacement over a plain-json annotation file
    (only the query surface the converters use)."""

    def __init__(self, json_path: str):
        with open(json_path) as f:
            self.dataset: dict[str, Any] = json.load(f)
        self.imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self._img_anns: dict[int, list[dict]] = {}
        for ann in self.dataset.get("annotations", []):
            self._img_anns.setdefault(ann["image_id"], []).append(ann)

    def getCatIds(self, catNms: list[str] = ()) -> list[int]:
        names = set(catNms)
        return sorted(
            cid for cid, c in self.cats.items()
            if not names or c["name"] in names
        )

    def getImgIds(self, catIds: list[int] = ()) -> list[int]:
        if not catIds:
            return sorted(self.imgs)
        wanted = set(catIds)
        # pycocotools semantics: intersection (image contains ALL cats)
        ids = []
        for img_id, anns in self._img_anns.items():
            have = {a["category_id"] for a in anns}
            if wanted <= have:
                ids.append(img_id)
        return sorted(ids)

    def getAnnIds(self, imgIds=None, catIds=(), iscrowd=None) -> list[int]:
        img_ids = (
            [imgIds] if isinstance(imgIds, int) else list(imgIds or [])
        )
        anns = (
            [a for i in img_ids for a in self._img_anns.get(i, [])]
            if img_ids else list(self.anns.values())
        )
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def loadImgs(self, ids) -> list[dict]:
        ids = [ids] if isinstance(ids, int) else ids
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids) -> list[dict]:
        ids = [ids] if isinstance(ids, int) else ids
        return [self.cats[i] for i in ids]

    def loadAnns(self, ids) -> list[dict]:
        ids = [ids] if isinstance(ids, int) else ids
        return [self.anns[i] for i in ids]

    def annToMask(self, ann: dict) -> np.ndarray:
        info = self.imgs[ann["image_id"]]
        return ann_to_mask(ann, info["height"], info["width"])
