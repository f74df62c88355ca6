"""Spatial partitioning: image height split over a mesh's 'spatial' axis
(deeplabv3p_tpu/parallel/mesh.py:10-18).

The JAX package shards the height of every map over the 'spatial' axis of a
('data', 'spatial') mesh and lets GSPMD insert the halo exchanges and
all-gathers. PyTorch has none of that, so here every exchange is written
out:

* Ownership. Of a map of global height H, spatial rank s of S owns rows
  `block(H, S, s)` = `[s * c, min((s + 1) * c, H))`, c = ceil(H / S):
  GSPMD's layout. A block may be empty (64 px over 8 ranks leaves 4 feature
  rows at OS16).
* `partitioned(mesh, (H, W))` makes a forward spatial: inside it, the
  operators that look across rows (`ops.conv.conv2d_same`,
  `ops.resize.resize_bilinear`, the global means, the fused kernels' row
  slabs) take this rank's block of rows of each map and return its block of
  their output. A map's global height is looked up by its width, which is
  not split, and is that of the latest map of its width made
  (`Partition.height`, which checks the map's rows against it): an
  operator that makes a map records its size.
* `halo_rows` hands a rank the global rows its outputs need, from whichever
  ranks own them, any number of ranks away. Every rank works out from the
  shapes alone which rows every other rank needs, fills the rows it owns
  into zero slots of one buffer that holds only those halo rows, and one
  `all_reduce(SUM)` over the spatial group delivers them (each slot has one
  owner, so the sum is exact). Its backward sends each halo row's gradient
  back to its owner the same way, where it is added. Rows outside the image
  are the operator's own padding, added by the caller.
* `global_mean_hw` and `all_rows` sum over the spatial group,
  differentiably (`AllReduceSum`); `gather_rows` gives every rank of the
  group the whole map (the mask of a request, a device-cached batch before
  augmentation).

Only `all_reduce` is used, so the exchange runs on gloo with CUDA tensors.
The gradients of a spatial group's ranks add up to those of the data
group's loss (see `train.make_train_step`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from deeplabv3p_torch.parallel.mesh import AllReduceSum

_state = threading.local()


def block(h: int, size: int, index: int) -> tuple[int, int]:
    """Rows [lo, hi) of a map of height h that spatial rank `index` of
    `size` owns (GSPMD's layout; possibly empty)."""
    c = -(-h // size)
    return min(index * c, h), min((index + 1) * c, h)


@dataclasses.dataclass
class Partition:
    """This rank's place on the spatial axis during one forward: `size`
    ranks in `group`, this one `index`; `heights` maps a map's width to the
    global height of the latest map of that width made (see `record`)."""

    size: int
    index: int
    group: object
    heights: dict

    def block(self, h: int, index: Optional[int] = None) -> tuple[int, int]:
        return block(h, self.size, self.index if index is None else index)

    def blocks(self, h: int) -> list[tuple[int, int]]:
        return [block(h, self.size, j) for j in range(self.size)]

    def height(self, x: torch.Tensor) -> int:
        """The global height of the NCHW map x, of which this rank holds
        its block: that of the latest map of x's width. Raises when x's
        rows are not this rank's block of it. Every height differs from
        every other in some rank's block, so a map read at a wrong height
        fails on at least one rank, which ends the group (`spawn`)."""
        width = x.shape[-1]
        try:
            h = self.heights[width]
        except KeyError:
            raise ValueError(f"no map {width} wide has been made in this spatial forward; "
                             f"known widths {sorted(self.heights)}") from None
        lo, hi = self.block(h)
        if x.shape[-2] != hi - lo:
            raise ValueError(f"a map {width} wide with {x.shape[-2]} rows on spatial rank "
                             f"{self.index} of {self.size} is no block of the latest map "
                             f"of that width, {h} rows high")
        return h

    def record(self, width: int, height: int) -> None:
        """A map `width` wide of global height `height` was made; it
        replaces an earlier height of that width. That is right because no
        model of the registry reads a map of the old height after one of
        the new is made: off multiples of the output stride a second height
        comes only from an operator that scales rows, and what follows reads
        only its maps: `unet_simple`'s 2x nearest (its decoder doubles 5 ->
        10 where the encoder pooled 9 -> 5, and it has no skips) and the
        subpixel head's depth-to-space (its output is the logits). Anywhere
        else two heights of one width would meet in a concat or an add,
        which raises in one process too. `height` checks each map read
        against the latest height."""
        self.heights[width] = height


@contextlib.contextmanager
def entered(part: Optional[Partition]):
    """Run what is inside under `part`: a forward's partition captured
    earlier (a checkpointed region's recompute runs in the backward, after
    `partitioned` has ended and maybe in another thread), or None."""
    prev = current()
    _state.partition = part
    try:
        yield part
    finally:
        _state.partition = prev


def suspended():
    """Run what is inside as one process would: on a map every rank of the
    spatial group holds whole (a replicated branch), no operator splits
    rows."""
    return entered(None)


def height_of(x: torch.Tensor) -> int:
    """The global height of the NCHW map x: its own outside a spatial
    forward, else `Partition.height`."""
    part = current()
    return x.shape[2] if part is None else part.height(x)


def partition_of(mesh) -> Partition:
    """A fresh `Partition` of `mesh`'s spatial axis, knowing no map yet."""
    return Partition(mesh.spatial, mesh.spatial_index, mesh.spatial_group, {})


def current() -> Optional[Partition]:
    """The partition of the spatial forward running in this thread, if any."""
    return getattr(_state, "partition", None)


@contextlib.contextmanager
def partitioned(mesh, image_hw: Sequence[int]):
    """Run the forward inside as this rank's block of rows of images of
    global size `image_hw` (H, W), when `mesh` has a spatial axis of more
    than one rank; else as it is."""
    if mesh is None or mesh.spatial == 1:
        yield None
        return
    part = partition_of(mesh)
    part.record(int(image_hw[1]), int(image_hw[0]))
    with entered(part):
        yield part


def own_rows(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of rows (along `dim`) of a batch of whole samples
    of its data group, on a mesh of more than one spatial rank."""
    lo, hi = block(x.shape[dim], mesh.spatial, mesh.spatial_index)
    return x.narrow(dim, lo, hi - lo)


def clip(a: int, b: int, h: int) -> tuple[int, int]:
    """[a, b) within [0, h), empty as (x, x)."""
    lo, hi = max(a, 0), min(b, h)
    return (lo, hi) if lo < hi else (lo, lo)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """One rank's part of a halo exchange of a map of height h: the slot
    rows of the buffer, the rows it sends, and where its own top and bottom
    halos sit."""

    total: int  # slot rows in the buffer
    sends: tuple  # (first local row, rows, first slot row) of rows this rank owns
    top: tuple  # (first slot row, rows) of this rank's halo above its block
    mid: tuple  # (first local row, rows) of its own rows it keeps
    bottom: tuple  # (first slot row, rows) of its halo below its block


@functools.lru_cache(maxsize=4096)
def _plan(h: int, size: int, index: int, needs: tuple) -> _Plan:
    owns = [block(h, size, j) for j in range(size)]
    segments, total = [], 0  # per rank: (top, bottom) as (global lo, hi, slot)
    for (lo, hi), (a, b) in zip(owns, needs):
        a, b = clip(a, b, h)
        top = (a, max(a, min(lo, b)))
        bottom = (min(max(hi, a), b), b)
        segments.append(((*top, total), (*bottom, total + top[1] - top[0])))
        total += (top[1] - top[0]) + (bottom[1] - bottom[0])
    lo, hi = owns[index]
    sends = []
    for j, segs in enumerate(segments):
        if j == index:
            continue
        for s_lo, s_hi, slot in segs:
            i_lo, i_hi = max(s_lo, lo), min(s_hi, hi)
            if i_lo < i_hi:
                sends.append((i_lo - lo, i_hi - i_lo, slot + i_lo - s_lo))
    (t_lo, t_hi, t_slot), (b_lo, b_hi, b_slot) = segments[index]
    a, b = clip(*needs[index], h)
    m_lo, m_hi = max(a, lo), min(b, hi)
    return _Plan(total, tuple(sends), (t_slot, t_hi - t_lo),
                 (m_lo - lo, max(m_hi - m_lo, 0)), (b_slot, b_hi - b_lo))


def _slots(x: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A zero (N, rows, W, C) buffer and its NCHW view (channels_last)."""
    n, c, _, w = x.shape
    raw = torch.zeros((n, rows, w, c), dtype=x.dtype, device=x.device)
    return raw, raw.permute(0, 3, 1, 2)


class _Halo(torch.autograd.Function):
    """Own rows -> the needed rows of the map (see `halo_rows`); backward
    sends the halo rows' gradients back to their owners."""

    @staticmethod
    def forward(ctx, x, plan: _Plan, group):
        ctx.plan, ctx.group = plan, group
        ctx.shape, ctx.last = x.shape, x.is_contiguous(memory_format=torch.channels_last)
        m0, mn = plan.mid
        if plan.total == 0:
            return x[:, :, m0:m0 + mn].clone()
        raw, buf = _slots(x, plan.total)
        for src, n, slot in plan.sends:
            buf[:, :, slot:slot + n] = x[:, :, src:src + n]
        dist.all_reduce(raw, group=group)
        (t0, tn), (b0, bn) = plan.top, plan.bottom
        return torch.cat([buf[:, :, t0:t0 + tn], x[:, :, m0:m0 + mn],
                          buf[:, :, b0:b0 + bn]], dim=2)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        fmt = torch.channels_last if ctx.last else torch.contiguous_format
        gx = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device).contiguous(
            memory_format=fmt)
        (t0, tn), (m0, mn), (b0, bn) = plan.top, plan.mid, plan.bottom
        gx[:, :, m0:m0 + mn] = g[:, :, tn:tn + mn]
        if plan.total:
            raw, buf = _slots(gx, plan.total)
            buf[:, :, t0:t0 + tn] = g[:, :, :tn]
            buf[:, :, b0:b0 + bn] = g[:, :, tn + mn:]
            dist.all_reduce(raw, group=ctx.group)
            for dst, n, slot in plan.sends:
                gx[:, :, dst:dst + n] += buf[:, :, slot:slot + n]
        return gx, None, None


def halo_rows(x: torch.Tensor, h: int, needs: Sequence[tuple[int, int]],
              part: Partition) -> tuple[torch.Tensor, int, int]:
    """This rank's rows `needs[index]` = [a, b) (global, maybe past the
    image's edges) of an NCHW map of global height h of which x holds its
    block, given what every rank of the spatial group needs (`needs[j]`,
    the same list on every rank). Returns (the rows inside the image,
    [max(a, 0), min(b, h)), the rows missing above 0, those missing below
    h): the caller pads those with its operator's padding."""
    needs = tuple((int(a), int(b)) for a, b in needs)
    plan = _plan(h, part.size, part.index, needs)
    a, b = needs[part.index]
    if a >= b:
        top = bottom = 0
    else:
        top, bottom = max(0, min(b, 0) - a), max(0, b - max(a, h))
    return _Halo.apply(x, plan, part.group), top, bottom


def slab_needs(h: int, part: Partition, halo: int) -> list[tuple[int, int]]:
    """Every rank's block of a map of height h widened by `halo` rows each
    side (nothing for an empty block): the rows a stencil of that reach
    needs to compute the block, its own zero padding standing in past the
    image's edges."""
    return [(lo - halo, hi + halo) if lo < hi else (lo, lo) for lo, hi in part.blocks(h)]


def global_mean_hw(x: torch.Tensor, part: Partition) -> torch.Tensor:
    """The mean over (H, W) of an NCHW map of which x is this rank's block,
    (N, C, 1, 1) in x's dtype: f32 sums added over the spatial group, over
    the global count."""
    count = part.height(x) * x.shape[-1]
    s = AllReduceSum.apply(x.float().sum(dim=(2, 3), keepdim=True), part.group)
    return (s / count).to(x.dtype)


def all_rows(x: torch.Tensor, h: int, part: Partition) -> torch.Tensor:
    """The whole NCHW map (global height h) on every rank of the spatial
    group from each rank's block, differentiably: the block in zero rows,
    summed over the group (`AllReduceSum`, whose backward hands each rank
    the sum of the ranks' gradients of its rows). For what mixes every row
    with every other, such as MobileViT's attention."""
    lo, hi = part.block(h)
    return AllReduceSum.apply(torch.nn.functional.pad(x, (0, 0, lo, h - hi)), part.group)


def rows_through(x: torch.Tensor, h_in: int, h_out: int, r: int, fn, part: Partition):
    """`fn` (an operator that makes output row o from input row o // r: a
    depth-to-space, a k2s2 transposed conv) on this rank's block: the input
    rows its output block [lo, hi) of `h_out` needs arrive by `halo_rows`,
    and the output is cropped to the block."""
    needs = [(lo // r, -(-hi // r)) if lo < hi else (lo // r, lo // r)
             for lo, hi in part.blocks(h_out)]
    slab, _, _ = halo_rows(x, h_in, needs, part)
    lo, hi = part.block(h_out)
    first = needs[part.index][0] * r
    y = fn(slab)[:, :, :0] if lo == hi else fn(slab)[:, :, lo - first:hi - first]
    return y.contiguous(memory_format=torch.channels_last)


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """`x.float().mean((H, W))` in x's dtype, of the whole map inside a
    spatial forward (the SE blocks' squeeze)."""
    part = current()
    if part is None:
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
    return global_mean_hw(x, part)


@torch.no_grad()
def gather_rows(x: torch.Tensor, h: int, part: Partition, dim: int = 1) -> torch.Tensor:
    """The whole map (global height h along `dim`) on every rank of the
    spatial group, from each rank's block: one `all_reduce` of zero-filled
    rows, exact for any dtype gloo sums."""
    lo, hi = part.block(h)
    shape = list(x.shape)
    shape[dim] = h
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, lo, hi - lo).copy_(x)
    dist.all_reduce(full, group=part.group)
    return full
