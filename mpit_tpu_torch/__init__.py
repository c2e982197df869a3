"""mpit_tpu_torch — the PyTorch/CUDA port of :mod:`mpit_tpu` for NVIDIA Hopper.

The JAX package stays the reference this port is held against; the port
imports nothing of it.  Module paths and public names mirror it.  Kernels
written for Hopper live under :mod:`mpit_tpu_torch.ops` and are built on
first use.
"""
