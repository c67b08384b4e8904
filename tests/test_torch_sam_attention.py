"""The port's SAM attention (lmdx_torch/nn/kernels/sam_attention.py) held
against the JAX package's (lmdx/nn/pallas/sam_attention.py) on the CPU.

On a CPU tensor the wrapper computes its plain version, so these tests pin
the math the CUDA kernel is held to on the card (tests/test_torch_kernels_
gpu.py). Inputs are made with numpy from a seed and handed to both sides.

Tolerances: the plain version against the JAX side's materialized XLA path
1e-5 absolute (f32 sums in other orders); against the Pallas kernel in
interpret mode 4e-2, the JAX package's own for that kernel
(tests/test_sam_attention.py): its products run in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import sam_attention as jsa
from lmdx_torch.nn.kernels import sam_attention as tsa

SHAPES = [(8, 8, 32), (16, 16, 64), (8, 16, 16), (14, 14, 64)]


def _inputs(b, h, gh, gw, d, seed=0):
    rng = np.random.default_rng(seed)
    n = gh * gw
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in
                 ((b, h, n, d), (b, h, n, d), (b, h, n, d), (b, h, n, gh), (b, h, n, gw)))


@pytest.mark.parametrize("gh,gw,d", SHAPES)
def test_plain_matches_xla(gh, gw, d):
    args = _inputs(2, 2, gh, gw, d)
    want = jsa.xla_sam_attention(*map(jnp.asarray, args))
    got = tsa.sam_attention_plain(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("gh,gw,d", SHAPES)
def test_plain_matches_pallas_interpret(gh, gw, d):
    args = _inputs(1, 2, gh, gw, d, seed=1)
    want = jsa.sam_attention_interpret(*map(jnp.asarray, args))
    got = tsa.sam_attention_plain(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=4e-2, atol=4e-2)


def test_cpu_wrapper_is_the_plain_version():
    args = tuple(map(torch.from_numpy, _inputs(1, 2, 14, 14, 64, seed=2)))
    tsa.reset_launch_counts()
    np.testing.assert_array_equal(tsa.sam_attention(*args).numpy(),
                                  tsa.sam_attention_plain(*args).numpy())
    assert tsa.LAUNCHES["sam_attention"] == 0


@pytest.mark.parametrize("shape,gh,gw", [
    ((1, 12, 4096, 64), 64, 64),    # ViT-B global layer
    ((1, 12, 4096, 64), 64, 32),    # grid mismatch
    ((25, 12, 196, 64), 14, 14),    # ViT-B 14x14 window
    ((1, 2, 16, 8), 4, 4),          # tiny SAM window: plain math
    ((1, 2, 64, 16), 8, 8),         # tiny SAM global layer: plain math
])
def test_kernel_gate_matches_jax(shape, gh, gw):
    assert tsa.kernel_supported(torch.zeros(shape), gh, gw) == jsa._kernel_supported(
        jnp.zeros(shape), gh, gw)
