"""Twins of the JAX package's single-process example scripts (`examples/`),
on the port: `python -m transfusion_tpu_torch.examples.<name>`, with the
JAX script's flags and defaults plus `--device` (default `cuda`)."""
