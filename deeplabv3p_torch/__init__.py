"""deeplabv3p_torch — PyTorch + CUDA (Hopper) port of deeplabv3p_tpu.

The JAX package `deeplabv3p_tpu` is the reference; this package mirrors
its module names so each counterpart is easy to find:

* `models/` — `nn.Module`s whose parameter names follow the flax scopes
  (`backbone.block_3.expanded_conv_3_expand.weight`, ...), run in
  `torch.channels_last` so the NHWC view the kernels take is free;
* `ops/kernels/` — hand-written CUDA kernels for sm_90a (built with nvcc
  at first use, bound with ctypes), each beside its plain PyTorch version;
* `utils/weights.py` — the weight bridge from the JAX variables tree;
* `inference.py` / `deeplab.py` — the serving entry points.

Importing this package never imports JAX, and pulls in neither PIL, cv2
nor h5py: those are imported inside the functions that need them.
"""

__version__ = "0.1.0"
