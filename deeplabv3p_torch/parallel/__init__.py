"""Parallelism over processes (deeplabv3p_tpu/parallel): one rank a device,
gradients and BatchNorm statistics summed by `all_reduce` (`mesh.py`), and
on a ('data', 'spatial') mesh each image's rows split over a spatial group
with the halo exchanges written out (`spatial.py`)."""

from deeplabv3p_torch.parallel.mesh import (  # noqa: F401
    AllReduceSum,
    Mesh,
    broadcast_module,
    check_batch,
    local_rows,
    make_mesh,
    reduce_gradients,
    set_batchnorm_group,
    shard_batch,
    spawn,
)
