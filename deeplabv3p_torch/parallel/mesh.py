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

Only `all_reduce` and `broadcast` are used: the two collectives that gloo
also runs on CUDA tensors. Spatial partitioning (the JAX package's
('data', 'spatial') mesh) is ROADMAP Queue A item 11.
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

import torch
import torch.distributed as dist

# a collective that waits longer than this raises on every rank (gloo's own
# default is 30 minutes, NCCL's 10); the longest wait the trainer makes is
# ranks > 0 waiting for rank 0's BN recalibration (`--bn_recalibrate`)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
BUCKET_BYTES = 32 << 20
SPATIAL_REFUSAL = ("spatial partitioning (a ('data', 'spatial') mesh) is not ported yet "
                   "(ROADMAP Queue A item 11, spatial partitioning)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel run: it holds rows
    `[rank * b, (rank + 1) * b)` of every global batch of `size * b` rows,
    on `device`. `group` is None on the single-device path."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None


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
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Join this process, rank `rank` of `num_devices`, to the default
    process group and return its `Mesh` (JAX `make_mesh(num_devices)`).

    An index-less `cuda` becomes `cuda:<local_rank (default: rank) modulo
    the visible cards>`. `init_method` is the rendezvous (`file://...` as
    `spawn` gives it, or `env://` under torchrun). `backend` defaults to
    NCCL for `cuda` and gloo for `cpu`; naming one also makes a group of a
    single rank (the same code path as N ranks). With one rank and no
    backend there is no group.
    """
    if num_devices < 1 or not 0 <= rank < num_devices:
        raise ValueError(f"rank {rank} of {num_devices} devices")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = rank if local_rank is None else local_rank
        device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    if num_devices == 1 and backend is None:
        return Mesh(0, 1, device, None)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=num_devices, rank=rank, timeout=timeout)
    return Mesh(rank, num_devices, device, dist.group.WORLD)


def local_rows(x, mesh: Optional[Mesh]):
    """This rank's contiguous block of the leading axis of `x` (a global
    batch), which must divide over the mesh as in JAX."""
    if mesh is None or mesh.size == 1:
        return x
    check_batch(x.shape[0], mesh.size)
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's rows of each array of a global batch (JAX
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
def reduce_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Average the parameters' `.grad` over the ranks of `group`: a
    flattened, bucketed `all_reduce`, divided by the world size. Parameters
    without a gradient are left out, on every rank alike (the ranks run the
    same model and freeze level)."""
    world = dist.get_world_size(group)

    def average(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _coalesced([p.grad for p in params if p.grad is not None], average)


@torch.no_grad()
def broadcast_module(model: torch.nn.Module, group, src: int = 0) -> None:
    """Every parameter and buffer of `model` becomes rank `src`'s."""
    tensors = [p.detach() for p in model.parameters()] + list(model.buffers())
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
               init_method: str, out_dir: str) -> None:
    _exit_with_parent()
    if torch.device(device).type == "cpu":  # the ranks share the cores
        torch.set_num_threads(max(1, torch.get_num_threads() // num_devices))
    mesh = make_mesh(num_devices, device, rank=rank, init_method=init_method,
                     backend=backend, timeout=timeout)
    try:
        out = fn(mesh, *args)
    finally:
        if mesh.group is not None:
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, num_devices: int, *args, device="cuda", backend: Optional[str] = None,
          timeout: datetime.timedelta = DEFAULT_TIMEOUT,
          join_timeout: Optional[float] = None) -> list:
    """Run `fn(mesh, *args)` in `num_devices` new processes (spawned, one
    rank each) and return the ranks' return values in rank order.

    `fn` and `args` are pickled, so `fn` is a module-level function. A rank
    that raises ends the others and raises here with its traceback; so does
    a run longer than `join_timeout` seconds. A CPU rank takes its share of
    the cores' threads."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="deeplabv3p_mesh_") as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=num_devices, join=False, start_method="spawn",
            args=(fn, args, num_devices, str(device), backend, timeout,
                  "file://" + os.path.join(tmp, "store"), tmp))
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
