"""The benchmark of `deeplabv3p_torch` on an NVIDIA H100 (`python3 -m
segbench.run`); BENCHMARK.json at the repository's root is its manifest."""
