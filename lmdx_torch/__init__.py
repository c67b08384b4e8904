"""lmdx_torch: the PyTorch/CUDA port of lmdx for NVIDIA Hopper (H100).

A package beside the JAX package `lmdx`, with the same layout (config, core,
text, nn, nn/kernels, runtime, sampling, methods, eval, utils, cli). It
imports torch, numpy and scipy (PIL for `utils.vis`), never jax or lmdx.
Entry points (`runtime.models.load_bundle`, `runtime.models.build_sam`,
`runtime.models.load_segmenter`, `methods.get_method(name).run`,
`methods.batch.run_lmd_plus_batch`, `methods.batch.run_lmd_batch`) run on
`cuda` unless the caller passes `device="cpu"`; the stage-1 modules (`text`,
`eval`, `cli`) run on the host only. The CUDA kernels live in `csrc/` and are built on first use
into build/kernels/ (see nn/kernels/build.py).
"""
