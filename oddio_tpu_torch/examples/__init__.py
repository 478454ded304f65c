"""Twins of the repo's ``examples/*.py`` on the port: each module's
``main(device=None)`` renders on the CUDA card unless it is given another
device (``main(device="cpu")``), writes the same files and prints the same
lines as its JAX twin.  Run one as ``python3 -m
oddio_tpu_torch.examples.<name>``."""
