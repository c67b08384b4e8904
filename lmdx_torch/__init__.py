"""lmdx_torch: the PyTorch/CUDA port of lmdx for NVIDIA Hopper (H100).

A package beside the JAX package `lmdx`, with the same layout (config, core,
text, nn, nn/kernels, runtime, sampling, methods). It imports torch, numpy
and scipy, never jax or lmdx. Entry points (`runtime.models.load_bundle`,
`runtime.models.build_sam`, `methods.batch.run_lmd_plus_batch`,
`methods.batch.run_lmd_batch`) run on `cuda` unless the caller passes
`device="cpu"`. The CUDA kernels live in `csrc/` and are built on first use
into build/kernels/ (see nn/kernels/build.py).
"""
