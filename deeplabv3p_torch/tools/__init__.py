"""Command-line tools of the port, one module each (`python -m
deeplabv3p_torch.tools.<name>`), counterparts of the JAX package's `tools/`."""
