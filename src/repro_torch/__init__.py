"""SpecRouter in PyTorch for one NVIDIA H100: the port of the JAX package
``repro`` (kept as the reference), module for module.

Entry points (``core.ModelPool``, ``core.ChainRouter``) run on the card by
default and raise when none is present; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the host.
"""
