"""PyTorch / CUDA port of the Mimose input-aware checkpointing planner.

A second package beside the JAX reference (``repro``), with the same
subpackage layout so each module's counterpart is easy to find.  It
imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``: what it needs from the reference's framework-free modules is
copied here.

The attention of every block can run through three hand-written CUDA
kernels for Hopper (``kernels/csrc/flash_attention.cu``), built with
``nvcc`` at first use into ``build/repro_torch/``.  For CPU tensors each
kernel wrapper runs its plain PyTorch version; for CUDA tensors it
launches the kernel or raises.
"""
