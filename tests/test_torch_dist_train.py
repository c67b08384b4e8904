"""The port's sharded train step (`training/train.py::{shard_state,
make_sharded_train_step}`) at dp 2 x tp 2 on the CPU in four gloo processes,
against the JAX package's single-device step, as
`tests/test_dist.py::test_sharded_train_step_matches_single_device` holds
the JAX sharded step: the tiny-test UNet (`tests/_torch_tiny.py`, GLIGEN
gates open), batch 4 (two examples on each dp row), `make_optimizer(1e-3)`
over every parameter.

- The loss (the mean over dp) within 1e-4 relative.
- The first step's gradients, read from Adam's first moment (0.1 g on both
  sides), within 1e-4 of each tensor's max |g|, gathered whole over tp.
- The parameters within rtol 1e-4 / atol 1e-6 wherever the JAX gradient
  is above 1e-4 of its tensor's max: Adam's first step moves an element by
  about lr * sign(g), so an element whose gradient is within the packages'
  rounding of zero may move the other way; there they are within 2 * lr.
- `shard_state`: every moment has its parameter's shard shape, and the
  split follows `param_spec`; the adapter mask trains the same names at
  tp 2 and leaves the rest unchanged; a checkpoint saved at tp 2 restores at
  tp 1 to the gathered whole tensors bit for bit, and one saved at tp 1
  restores at tp 2 to the same shards bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lmdx.core import schedule as jsched
from lmdx.nn.unet import UNet2DCondition as JaxUNet
from lmdx.runtime import models as jmodels
from lmdx.training import train as jtrain
from lmdx_torch.runtime import convert
from tests._torch_dist import run_ranks
from tests._torch_tiny import tiny_params

LR = 1e-3
BATCH = 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg = jmodels.SD_CONFIGS["tiny-test"]()
    params = tiny_params(0)["unet"]
    rng = np.random.default_rng(11)
    d = cfg.unet.cross_attention_dim
    batch = {
        "x0": rng.standard_normal((BATCH, 16, 16, 4)).astype(np.float32),
        "noise": rng.standard_normal((BATCH, 16, 16, 4)).astype(np.float32),
        "t": np.array([10, 200, 500, 900], np.int32),
        "text_embeddings": (rng.standard_normal((BATCH, 77, d)) * 0.5).astype(np.float32),
        "objs": (rng.standard_normal((BATCH, 8, d)) * 0.5).astype(np.float32),
    }
    alphas = np.asarray(jsched.make_schedule(50).alphas_cumprod, np.float32)
    opt = jtrain.make_optimizer(LR)
    step = jtrain.make_train_step(JaxUNet(cfg.unet, dtype=jnp.float32), opt,
                                  jnp.asarray(alphas), objs_fn=lambda p, b: b["objs"])
    state = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), opt)
    new, loss = jax.jit(step)(state, jax.tree_util.tree_map(jnp.asarray, batch))
    want = {"loss": float(loss),
            "params": convert.state_dict_from_tree(jax.tree_util.tree_map(np.asarray,
                                                                          new.params)),
            "grads": {k: v / 0.1 for k, v in convert.state_dict_from_tree(
                jax.tree_util.tree_map(np.asarray, new.opt_state[0].mu)).items()}}
    tmp = tmp_path_factory.mktemp("train")
    args = {"unet": convert.state_dict_from_tree(params), "batch": batch, "alphas": alphas,
            "lr": LR, "ckpt": str(tmp / "ckpt")}
    return run_ranks("train", 4, args, tmp), want, convert.state_dict_from_tree(params)


def test_sharded_step_loss_matches_jax(results):
    ranks, want, _ = results
    for r in ranks:
        assert r["batch_rows"] == BATCH // 2
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-4)


def test_sharded_step_gradients_match_jax(results):
    ranks, want, _ = results
    for r in ranks:
        for name, m in r["exp_avg"].items():
            g, w = m / 0.1, want["grads"][name].numpy()
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


def test_sharded_step_parameters_match_jax(results):
    ranks, want, _ = results
    for r in ranks:
        for name, got in r["params"].items():
            w, g = want["params"][name].numpy(), want["grads"][name].numpy()
            assert np.abs(got - w).max() <= 2 * LR, name
            sure = np.abs(g) > 1e-4 * np.abs(g).max()
            np.testing.assert_allclose(got[sure], w[sure], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    for r in ranks[1:]:
        for name, got in r["params"].items():
            np.testing.assert_array_equal(got, ranks[0]["params"][name])


def test_shard_state_moments_take_the_shard_shapes(results):
    ranks, _, whole = results
    r = ranks[0]
    assert r["moment_shapes"] == r["local_shapes"]
    n_split = 0
    for name, shape in r["local_shapes"].items():
        full = tuple(whole[name].shape)
        kind = r["spec"][name]
        if kind == "column":
            assert shape == (full[0] // 2, *full[1:]), name
        elif kind == "row":
            assert shape == (full[0], full[1] // 2), name
        else:
            assert shape == full, name
        n_split += kind != "whole"
    # Tiny-test's 2 heads and every MLP split at tp 2: nothing is kept whole.
    assert not {n for n, k in r["spec"].items() if k == "whole" and (
        ".to_q." in n or ".net.0.proj." in n or "linear_1" in n)}
    assert n_split > 0


def test_adapter_mask_at_tp2(results):
    ranks, _, whole = results
    adapters = {n for n in whole if ".fuser." in n}
    for r in ranks:
        assert r["mask"]["trained"] == adapters
        assert r["mask"]["opt_count"] == len(adapters)
        assert r["mask"]["changed"] == adapters


def test_checkpoint_saved_at_tp2_restores_at_tp1_and_back(results):
    ranks, _, _ = results
    for r in ranks:
        one = r["restored_tp1"]
        assert one["step"] == 1 and r["restored_tp2_step"] == 1
        for name, p in r["params"].items():
            np.testing.assert_array_equal(one["params"][name], p, err_msg=name)
            np.testing.assert_array_equal(one["exp_avg"][name], r["exp_avg"][name],
                                          err_msg=name)
        assert r["restored_tp2_equal"]
