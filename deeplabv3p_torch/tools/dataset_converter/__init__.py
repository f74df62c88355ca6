"""Dataset preparation tools of the port, one module each (`python -m
deeplabv3p_torch.tools.dataset_converter.<name>`): copies of the JAX
package's `tools/dataset_converter/` that import the port instead, so they
run where JAX is not installed. Flags, outputs and file formats are the
root tools'."""
