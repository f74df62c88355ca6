"""Data parallelism over processes (deeplabv3p_tpu/parallel/mesh.py).

The JAX package shards the global batch's leading axis over a 'data' mesh
axis in contiguous blocks, replicates the parameters, and lets GSPMD insert
the gradient psum and the global-batch BatchNorm statistics. Here a rank is
a process that drives one device:

* `make_mesh` joins this process to a process group (NCCL on `cuda`, gloo
  on `cpu`; a `backend=` keyword may name gloo on `cuda`, which lets two
  ranks share one card) and returns a `Mesh`: rank, size, device, group.
  One rank and no named backend is the single-device path, with no group.
* `shard_batch` keeps this rank's block of rows of a global batch, as
  `P('data')` places them on device `rank` (JAX mesh.py:72-99).
* `AllReduceSum` sums over the ranks in the forward and sums the gradient
  in the backward; `BatchNorm` (models/layers.py) reduces its per-channel
  `[sum x, sum x^2, count]` through it, so the statistics, and the
  gradient through them, are those of the global batch.
* `reduce_gradients` averages `.grad` over the ranks in flat buckets;
  `broadcast_module` copies rank 0's parameters and buffers to every rank.
* `spawn` runs a function in N new processes, one rank each, through a
  `file://` store in a temporary directory (no port, no network), and
  returns what each rank returned.

A 2-D mesh (`axis_names=("data", "spatial")`, JAX mesh.py:43-69) lays
the ranks out as `rank = data_index * S + spatial_index`, as
`np.asarray(devices).reshape(mesh_shape)` lays out JAX's devices: the S
ranks of a data group split each of its samples by height
(`parallel/spatial.py`), and the D data groups split the batch. The mesh
then also carries this rank's spatial group (halo rows, global means, the
mask's rows) and data group, besides `group`, all ranks (gradients and
BatchNorm statistics, which JAX reduces over both axes).

Only `all_reduce` and `broadcast` are used: the two collectives that gloo
also runs on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises on every rank (gloo's own
# default is 30 minutes, NCCL's 10); the longest wait the trainer makes is
# ranks > 0 waiting for rank 0's BN recalibration (`--bn_recalibrate`)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
BUCKET_BYTES = 32 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a run: it holds rows `[d * b, (d + 1) * b)`
    of every global batch of `D * b` rows, d its data index, on `device`;
    on a 2-D mesh of `spatial` S > 1 ranks a data group, only its block of
    each sample's rows (`parallel/spatial.py`). `group` (all ranks) is None
    on the single-device path; `spatial_group` and `data_group` are this
    rank's groups along the two axes of a 2-D mesh of more than one rank
    (`data_group` None where the data axis has one rank)."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None
    axis_names: tuple = ("data",)
    spatial: int = 1
    spatial_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def data_size(self) -> int:
        return self.size // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial


def auto_shape(n: int, n_axes: int) -> tuple[int, ...]:
    """JAX `_auto_shape` (mesh.py:30-40): on two axes, spatial is the
    largest power of two that divides n, capped at 4."""
    if n_axes == 1:
        return (n,)
    spatial = 1
    while spatial < 4 and n % (spatial * 2) == 0:
        spatial *= 2
    return (n // spatial, spatial)


def check_batch(batch_size: int, num_devices: int) -> None:
    """A global batch splits into equal blocks of rows, or raises (JAX
    data/device_cache.py:90-94): every rank must hold as many pixels for
    the averaged gradient to be the global batch's."""
    if batch_size % num_devices:
        raise ValueError(f"batch_size {batch_size} must divide over the mesh's data axis "
                         f"({num_devices})")


def make_mesh(num_devices: int = 1, device="cuda", *, rank: int = 0,
              local_rank: Optional[int] = None, init_method: Optional[str] = None,
              backend: Optional[str] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT,
              axis_names: tuple = ("data",), mesh_shape: Optional[tuple] = None) -> Mesh:
    """Join this process, rank `rank` of `num_devices`, to the default
    process group and return its `Mesh` (JAX `make_mesh(num_devices,
    axis_names, mesh_shape=...)`). `axis_names=("data", "spatial")` makes
    the 2-D mesh, shaped `mesh_shape` (D, S) or by `auto_shape`; every rank
    then makes the D spatial groups and the S data groups (where D > 1), in
    that order.

    An index-less `cuda` becomes `cuda:<local_rank (default: rank) modulo
    the visible cards>`. `init_method` is the rendezvous (`file://...` as
    `spawn` gives it, or `env://` under torchrun). `backend` defaults to
    NCCL for `cuda` and gloo for `cpu`; naming one also makes a group of a
    single rank (the same code path as N ranks). With one rank and no
    backend there is no group.
    """
    if num_devices < 1 or not 0 <= rank < num_devices:
        raise ValueError(f"rank {rank} of {num_devices} devices")
    axis_names = tuple(axis_names)
    if axis_names not in (("data",), ("data", "spatial")):
        raise ValueError(f"axis_names {axis_names}: ('data',) or ('data', 'spatial')")
    shape = tuple(mesh_shape) if mesh_shape is not None else auto_shape(
        num_devices, len(axis_names))
    if len(shape) != len(axis_names) or int(np.prod(shape)) != num_devices:
        raise ValueError(f"mesh_shape {shape} for axes {axis_names} and {num_devices} devices")
    spatial = shape[1] if len(shape) == 2 else 1
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = rank if local_rank is None else local_rank
        device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    if num_devices == 1 and backend is None:
        return Mesh(0, 1, device, None, axis_names)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=num_devices, rank=rank, timeout=timeout)
    if len(axis_names) == 1:
        return Mesh(rank, num_devices, device, dist.group.WORLD)
    d_size = num_devices // spatial
    # every rank makes every group, in the same order (dist.new_group)
    spatial_groups = [dist.new_group([d * spatial + s for s in range(spatial)])
                      for d in range(d_size)]
    data_groups = ([dist.new_group([d * spatial + s for d in range(d_size)])
                    for s in range(spatial)] if d_size > 1 else [None] * spatial)
    return Mesh(rank, num_devices, device, dist.group.WORLD, axis_names, spatial,
                spatial_groups[rank // spatial], data_groups[rank % spatial])


def local_rows(x, mesh: Optional[Mesh]):
    """This rank's contiguous block of the leading axis of `x` (a global
    batch), which must divide over the mesh's data axis as in JAX; on a 2-D
    mesh an array of rank >= 3 (N, H, ...) keeps only this rank's block of
    rows of H as well (JAX `batch_arg_sharding`, mesh.py:72-90)."""
    if mesh is None or mesh.size == 1:
        return x
    check_batch(x.shape[0], mesh.data_size)
    b = x.shape[0] // mesh.data_size
    x = x[mesh.data_index * b:(mesh.data_index + 1) * b]
    if mesh.spatial > 1 and x.ndim >= 3:
        from deeplabv3p_torch.parallel.spatial import block

        lo, hi = block(x.shape[1], mesh.spatial, mesh.spatial_index)
        x = x[:, lo:hi]
    return x


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's share of each array of a global batch (JAX
    `shard_batch`, mesh.py:93-99, which places each device's block)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(local_rows(x, mesh) for x in batch)
    return local_rows(batch, mesh)


class AllReduceSum(torch.autograd.Function):
    """`all_reduce(SUM)` of a tensor over `group`, differentiable: the
    gradient of a sum over the ranks is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _coalesced(tensors: Iterable[torch.Tensor], op: Callable[[torch.Tensor], None],
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Run `op` in place on flat buckets of `tensors` (by dtype and device,
    in order, up to `bucket_bytes` each) and copy the results back. Every
    rank must pass the same shapes in the same order."""
    buckets: dict = {}  # (dtype, device) -> [[tensors], bytes] of the open bucket, ...
    for t in tensors:
        chunks = buckets.setdefault((t.dtype, t.device), [[[], 0]])
        if chunks[-1][1] >= bucket_bytes:
            chunks.append([[], 0])
        chunks[-1][0].append(t)
        chunks[-1][1] += t.numel() * t.element_size()
    for chunks in buckets.values():
        for chunk, _ in chunks:
            flat = torch.cat([t.reshape(-1) for t in chunk])
            op(flat)
            for t, piece in zip(chunk, flat.split([t.numel() for t in chunk])):
                t.copy_(piece.view(t.shape))


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.Tensor], group,
                     divisor: Optional[int] = None) -> None:
    """Sum the parameters' `.grad` over the ranks of `group` and divide by
    `divisor` (default: the world size, the average): a flattened, bucketed
    `all_reduce`. On a 2-D mesh the divisor is the data axis's size: a
    spatial group's ranks hold parts of one loss, whose gradients add up.
    Parameters without a gradient are left out, on every rank alike (the
    ranks run the same model and freeze level)."""
    world = dist.get_world_size(group) if divisor is None else divisor

    def average(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _coalesced([p.grad for p in params if p.grad is not None], average)


@torch.no_grad()
def broadcast_module(model: torch.nn.Module, group, src: int = 0) -> None:
    """Every parameter and buffer of `model` becomes that of rank `src` of
    `group` (its rank within the group)."""
    tensors = [p.detach() for p in model.parameters()] + list(model.buffers())
    src = dist.get_global_rank(group, src) if group is not dist.group.WORLD else src
    _coalesced(tensors, lambda flat: dist.broadcast(flat, src, group=group))


def set_batchnorm_group(model: torch.nn.Module, group) -> None:
    """Every `BatchNorm` of `model` takes its training statistics over
    `group`'s global batch (None: over this process's batch)."""
    from deeplabv3p_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def _exit_with_parent() -> None:
    """End this process if the process that spawned it goes away, so that no
    rank outlives a killed launcher waiting in a collective."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


def _rank_main(rank: int, fn, args, num_devices: int, device: str, backend, timeout,
               init_method: str, out_dir: str, axis_names: tuple, mesh_shape) -> None:
    _exit_with_parent()
    if torch.device(device).type == "cpu":  # the ranks share the cores
        torch.set_num_threads(max(1, torch.get_num_threads() // num_devices))
    mesh = make_mesh(num_devices, device, rank=rank, init_method=init_method,
                     backend=backend, timeout=timeout, axis_names=axis_names,
                     mesh_shape=mesh_shape)
    try:
        out = fn(mesh, *args)
    finally:
        if mesh.group is not None:
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, num_devices: int, *args, device="cuda", backend: Optional[str] = None,
          timeout: datetime.timedelta = DEFAULT_TIMEOUT,
          join_timeout: Optional[float] = None, axis_names: tuple = ("data",),
          mesh_shape: Optional[tuple] = None) -> list:
    """Run `fn(mesh, *args)` in `num_devices` new processes (spawned, one
    rank each; `axis_names` and `mesh_shape` as `make_mesh` takes them) and
    return the ranks' return values in rank order.

    `fn` and `args` are pickled, so `fn` is a module-level function. A rank
    that raises ends the others and raises here with its traceback; so does
    a run longer than `join_timeout` seconds. A CPU rank takes its share of
    the cores' threads."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="deeplabv3p_mesh_") as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=num_devices, join=False, start_method="spawn",
            args=(fn, args, num_devices, str(device), backend, timeout,
                  "file://" + os.path.join(tmp, "store"), tmp, tuple(axis_names),
                  mesh_shape))
        deadline = None if join_timeout is None else time.monotonic() + join_timeout
        try:
            while not ctx.join(timeout=5.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{num_devices} ranks still running after "
                                       f"{join_timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10.0)
        out = []
        for rank in range(num_devices):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))  # written by this run's ranks
        return out
