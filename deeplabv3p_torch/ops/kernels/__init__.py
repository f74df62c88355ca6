"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

| wrapper                       | CUDA source       | replaces (Pallas TPU kernel)                         |
|-------------------------------|-------------------|------------------------------------------------------|
| `multirate_atrous_depthwise`  | `csrc/aspp.cu`    | `deeplabv3p_tpu/ops/pallas/aspp.py` `multirate_atrous_depthwise` |
| `fused_decoder_frontend`      | `csrc/decoder.cu` | `deeplabv3p_tpu/ops/pallas/decoder.py` `fused_decoder_frontend` |
| `upsample_ce_forward`         | `csrc/upsample_ce.cu` | `deeplabv3p_tpu/ops/pallas/upsample_ce.py` `_fwd_kernel` |
| `upsample_ce_backward`        | `csrc/upsample_ce.cu` | `deeplabv3p_tpu/ops/pallas/upsample_ce.py` `_bwd_kernel` |
| `confusion_matrix_fused`      | `csrc/confusion.cu` | `deeplabv3p_tpu/ops/pallas/confusion.py` `confusion_matrix_fused` |
| `fused_inverted_residual`     | `csrc/mbconv.cu`  | `deeplabv3p_tpu/ops/pallas/mbconv.py` `fused_inverted_residual` |
| `batchnorm_train_forward`     | `csrc/batchnorm.cu` | none: training-mode BatchNorm, which JAX leaves to XLA |
| `batchnorm_train_backward`    | `csrc/batchnorm.cu` | none (its gradient) |

`fused_upsample_ce` (in `upsample_ce.py`) is the differentiable loss tail
that launches the two `upsample_ce_*` kernels; `batchnorm_train` (in
`batchnorm.py`) is `models.layers.BatchNorm`'s training forward on CUDA
tensors, differentiable through the two `batchnorm_train_*` kernels.

Five of the six have been designed again for the card since their first
port (each source's note has the design, PERF.md the times):
`fused_inverted_residual` (tensor cores, weights in shared memory),
`upsample_ce_backward` (one column reduction a block),
`fused_decoder_frontend` (separable upsample in shared memory, the stencil's
vertical half at the encoder's width), `upsample_ce_forward` (a block a
low-resolution row pair, rows interpolated once, two-pass exp2 softmax in
registers) and `multirate_atrous_depthwise` (16 bytes a thread, the rows a
band's taps reach staged once in shared memory, the plan kept by call
signature).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Nothing here touches CUDA or nvcc at import.
"""

from deeplabv3p_torch.ops.kernels._build import (  # noqa: F401
    launch_counts,
    reset_launch_counts,
)
from deeplabv3p_torch.ops.kernels.aspp import (  # noqa: F401
    multirate_atrous_depthwise,
    multirate_atrous_depthwise_reference,
)
from deeplabv3p_torch.ops.kernels.batchnorm import (  # noqa: F401
    batchnorm_train,
    batchnorm_train_backward,
    batchnorm_train_backward_reference,
    batchnorm_train_forward,
    batchnorm_train_reference,
)
from deeplabv3p_torch.ops.kernels.confusion import (  # noqa: F401
    confusion_matrix_fused,
    confusion_matrix_fused_reference,
)
from deeplabv3p_torch.ops.kernels.decoder import (  # noqa: F401
    fused_decoder_frontend,
    fused_decoder_reference,
)
from deeplabv3p_torch.ops.kernels.mbconv import (  # noqa: F401
    fused_inverted_residual,
    fused_inverted_residual_reference,
)
from deeplabv3p_torch.ops.kernels.upsample_ce import (  # noqa: F401
    fused_upsample_ce,
    upsample_ce_backward,
    upsample_ce_backward_reference,
    upsample_ce_forward,
    upsample_ce_reference,
)
