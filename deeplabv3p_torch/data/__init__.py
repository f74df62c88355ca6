"""Data loading and batch preparation (deeplabv3p_tpu/data)."""
