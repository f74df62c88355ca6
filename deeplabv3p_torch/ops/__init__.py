"""Tensor ops: TF-'SAME' padding, resizes, activations, CUDA kernels."""
