"""ScALPEL in PyTorch for NVIDIA Hopper — the port of the JAX package
``repro`` (which stays the reference it is tested against).

Subpackages mirror the reference's: ``core`` (specs, plans, counters,
instrumentation, monitor, report, runtime), ``kernels`` (hand-written CUDA
kernels and their plain PyTorch versions), ``models``, ``configs`` and
``serve``.  Nothing here imports JAX or the ``repro`` package.
"""
