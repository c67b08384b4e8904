"""The port's training step and checkpoints (`lmdx_torch/training/`) against
the JAX package's (`lmdx/training/`) on the CPU at the tiny-test UNet, in
float32 and in the design mode, bf16 activations over float32 masters.

Weights: `tests/_torch_tiny.py::tiny_params` (GLIGEN gates open at 0.7 /
-0.4, so that every fuser parameter has a gradient), mapped onto the port by
`convert.state_dict_from_tree`. The batch is made with numpy from a seed at
16x16 latents: the 256-token self-attention and GLIGEN fuser of the first
level take the port's flash route (`FlashAttention`, its plain versions on
the CPU) in the forward and the backward.

- Loss and gradients: each package's `make_train_step`, with an optimizer
  that records the gradients it is handed instead of stepping (an optax
  transform on the JAX side); the loss within 1e-5 relative, every gradient
  within 1e-4 of its tensor's max |g|, with and without the adapter mask.
- bf16: the port's step on a UNet built for bfloat16 against the JAX step
  on `UNet2DCondition(dtype=bfloat16)`, the same float32 parameters and
  batch. Two bf16 implementations round at different points inside their
  ops (torch computes GELU, softmax and the norms' statistics in float32,
  XLA per op), so their gradients differ by bf16 noise: measured, the loss
  by 1.4e-5 relative and each gradient by at most 7.1e-2 of its norm
  (median 1.6e-2). The tolerances, 3e-5 and 0.15, sit at about twice that.
  The control, the port's float32 step against the same JAX bf16 step,
  lies outside both (5.9e-5; 0.33 at the first fuser's attention gate,
  whose gradient bf16 moves by a third in both packages). Noise at this
  level cannot see a norm's weights cast to bfloat16 (the tiny weights
  are exact in bf16), so a second test holds the step's dtypes: every
  flash forward and backward takes bf16 q/k/v, every Linear and Conv2d
  runs on a bf16 weight, every norm on its float32 one.
- AdamW: two updates of `make_optimizer(1e-3, 1e-2, adapter mask)` from the
  same (JAX) gradients against optax's, each step within 1e-7 absolute.
- Three steps end to end at lr 1e-4: losses within 1e-4 relative; the
  parameters within 2 * lr * steps (Adam's first steps move an element by
  about lr * sign(g), so an element whose gradient is within the packages'
  rounding of zero may move the other way) and, outside at most 0.1% of the
  elements, within 1e-6; the frozen parameters unchanged.
- `gligen_adapter_mask` names the JAX mask's parameters; the checkpoint
  round trip is bit for bit and the restored state steps as the saved one;
  `latest_step_dir` equals the JAX function on one directory tree.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmdx.core import schedule as jsched
from lmdx.nn.unet import UNet2DCondition as JaxUNet
from lmdx.runtime import models as jmodels
from lmdx.training import checkpoint as jckpt
from lmdx.training import train as jtrain
from lmdx_torch import config as tconfig
from lmdx_torch.nn.kernels import flash_attention as tfa
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.training import checkpoint as tckpt
from lmdx_torch.training import train as ttrain
from tests._torch_tiny import one_torch_thread, tiny_params

LATENT = 16
BATCH = 2


@pytest.fixture(scope="module")
def setup():
    jcfg = jmodels.SD_CONFIGS["tiny-test"]()
    params = tiny_params(0)["unet"]
    rng = np.random.default_rng(7)
    d = jcfg.unet.cross_attention_dim
    batch = {
        "x0": rng.standard_normal((BATCH, LATENT, LATENT, 4)).astype(np.float32),
        "noise": rng.standard_normal((BATCH, LATENT, LATENT, 4)).astype(np.float32),
        "t": np.array([10, 700], np.int32),
        "text_embeddings": (rng.standard_normal((BATCH, 77, d)) * 0.5).astype(np.float32),
        "objs": (rng.standard_normal((BATCH, jcfg.unet.gligen_max_objs, d)) * 0.5)
        .astype(np.float32),
    }
    alphas = np.asarray(jsched.make_schedule(50).alphas_cumprod, np.float32)
    return JaxUNet(jcfg.unet, dtype=jnp.float32), params, batch, alphas


def _objs(_, batch):
    return batch["objs"]


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


TOL_BF16_LOSS = 3e-5  # relative
TOL_BF16_GRAD = 0.15  # ||g - g_jax|| / ||g_jax||, each tensor


def _port_unet(params, dtype="float32"):
    cfg = dataclasses.replace(tconfig.SD_CONFIGS["tiny-test"](), dtype=dtype)
    return tmodels.build_train_unet(cfg, convert.state_dict_from_tree(params), device="cpu")


def _mask_names(mask_tree, params) -> set:
    """Port names of the parameters a JAX mask tree selects."""
    full = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                  mask_tree, params)
    return {k for k, v in convert.state_dict_from_tree(full).items() if bool(v.all())}


def _jax_record():
    """An optax transform whose state becomes the gradients it is given;
    its updates are zero."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


class _Record:
    """The port's counterpart: `init` marks the trained parameters as the
    AdamW spec does, and `update` keeps their gradients by name instead of
    stepping."""

    def __init__(self, mask=None):
        self.mask = mask
        self.grads = None

    def init(self, module):
        self.module = module
        return ttrain.AdamW(trainable_mask=self.mask).init(module)

    def update(self, optimizer):
        self.grads = {n: p.grad.detach().clone() for n, p in self.module.named_parameters()
                      if p.grad is not None}


def _jax_step_grads(unet, params, batch, alphas):
    rec = _jax_record()
    step = jtrain.make_train_step(unet, rec, jnp.asarray(alphas), objs_fn=_objs)
    state = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), rec)
    new_state, loss = jax.jit(step)(state, jax.tree_util.tree_map(jnp.asarray, batch))
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state)
    return float(loss), grads


@pytest.fixture(scope="module")
def jax_grads(setup):
    unet, params, batch, alphas = setup
    return _jax_step_grads(unet, params, batch, alphas)


@pytest.fixture(scope="module")
def jax_bf16_grads(setup):
    _, params, batch, alphas = setup
    unet = JaxUNet(jmodels.SD_CONFIGS["tiny-test"]().unet, dtype=jnp.bfloat16)
    return _jax_step_grads(unet, params, batch, alphas)


def _port_step_grads(params, batch, alphas, dtype="float32", mask=False):
    """One port step with the recording optimizer: (unet, loss, grads)."""
    with one_torch_thread():
        unet = _port_unet(params, dtype)
        rec = _Record(ttrain.gligen_adapter_mask(unet) if mask else None)
        step = ttrain.make_train_step(unet, rec, alphas, objs_fn=_objs)
        state = ttrain.init_train_state(unet, rec)
        state, loss = step(state, _port_batch(batch))
    assert state.step == 1
    return unet, float(loss), rec.grads


@pytest.mark.parametrize("adapter", [False, True], ids=["all", "adapter_mask"])
def test_loss_and_gradients_match_jax(setup, jax_grads, adapter):
    _, params, batch, alphas = setup
    want_loss, grads = jax_grads
    want = convert.state_dict_from_tree(grads)
    unet, loss, got = _port_step_grads(params, batch, alphas, mask=adapter)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    trained = {n for n, p in unet.named_parameters() if p.requires_grad}
    assert set(got) == trained
    if adapter:
        assert trained == {n for n in want if ".fuser." in n}
    else:
        assert trained == set(want)
    for name in sorted(trained):
        g, w = got[name].numpy(), want[name].numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(g - w).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"], ids=["bf16", "f32_control"])
def test_bf16_step_matches_jax_bf16(setup, jax_bf16_grads, dtype):
    """The port's bf16 step within the bf16 tolerances of the JAX bf16 step;
    its float32 step, the control, outside them."""
    _, params, batch, alphas = setup
    want_loss, grads = jax_bf16_grads
    want = convert.state_dict_from_tree(grads)
    unet, loss, got = _port_step_grads(params, batch, alphas, dtype)
    assert set(got) == set(want) == {n for n, _ in unet.named_parameters()}
    for name, g in got.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
    loss_gap = abs(loss - want_loss) / abs(want_loss)
    gaps = {n: float(np.linalg.norm(got[n].numpy() - w.numpy()) / np.linalg.norm(w.numpy()))
            for n, w in want.items()}
    worst = max(gaps, key=gaps.get)
    if dtype == "bfloat16":
        assert loss_gap <= TOL_BF16_LOSS, loss_gap
        assert gaps[worst] <= TOL_BF16_GRAD, (worst, gaps[worst])
    else:
        assert loss_gap > TOL_BF16_LOSS, loss_gap
        assert gaps[worst] > TOL_BF16_GRAD, (worst, gaps[worst])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_step_runs_at_the_unets_compute_dtype(setup, dtype, monkeypatch):
    """Inside one step: the flash layers' forward and backward take q/k/v at
    the compute dtype; every Linear and Conv2d runs on a weight at it, every
    norm on a float32 weight; the masters and their gradients stay float32."""
    _, params, batch, alphas = setup
    want = getattr(torch, dtype)
    seen = {"fwd": [], "bwd": [], "weight": {}}
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd

    def record_fwd(q, k, v):
        seen["fwd"].append({t.dtype for t in (q, k, v)})
        return fwd(q, k, v)

    def record_bwd(q, k, v, lse, o, do):
        seen["bwd"].append({t.dtype for t in (q, k, v, o, do)})
        return bwd(q, k, v, lse, o, do)

    monkeypatch.setattr(tfa, "flash_attention_fwd", record_fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd", record_bwd)
    def record_weight(name):
        def hook(mod, _):
            seen["weight"].setdefault(name, (type(mod), mod.weight.dtype))
        return hook

    unet = _port_unet(params, dtype)
    for name, m in unet.named_modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.LayerNorm,
                          torch.nn.GroupNorm)):
            m.register_forward_pre_hook(record_weight(name))
    opt = ttrain.make_optimizer(1e-4, trainable_mask=ttrain.gligen_adapter_mask(unet))
    step = ttrain.make_train_step(unet, opt, alphas, objs_fn=_objs)
    with one_torch_thread():
        step(ttrain.init_train_state(unet, opt), _port_batch(batch))
    assert seen["fwd"] and seen["bwd"]
    assert all(s == {want} for s in seen["fwd"] + seen["bwd"]), seen
    norms = {n for n, (cls, _) in seen["weight"].items()
             if issubclass(cls, (torch.nn.LayerNorm, torch.nn.GroupNorm))}
    assert norms and len(norms) < len(seen["weight"])
    for name, (_, dt) in seen["weight"].items():
        assert dt == (torch.float32 if name in norms else want), (name, dt)
    for name, p in unet.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None or p.grad.dtype == torch.float32, name


def test_adamw_update_matches_optax(setup, jax_grads):
    """Each of two updates on the same gradients: the port's parameter step
    (new - old, exact in float64) against optax's update, within 1e-7 (the
    rounding of the new parameter: optax adds one update, torch decays and
    adds in two operations)."""
    _, params, _, _ = setup
    _, grads = jax_grads
    jmask = jtrain.gligen_adapter_mask(params)
    jopt = jtrain.make_optimizer(1e-3, weight_decay=1e-2, trainable_mask=jmask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    jgrads = jax.tree_util.tree_map(jnp.asarray, grads)

    unet = _port_unet(params)
    opt = ttrain.make_optimizer(1e-3, weight_decay=1e-2,
                                trainable_mask=ttrain.gligen_adapter_mask(unet))
    state = ttrain.init_train_state(unet, opt)
    port_grads = convert.state_dict_from_tree(grads)
    for _ in range(2):
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want = convert.state_dict_from_tree(jax.tree_util.tree_map(np.asarray, updates))
        before = {n: p.detach().clone() for n, p in unet.named_parameters()}
        for name, p in unet.named_parameters():
            p.grad = port_grads[name].clone() if p.requires_grad else None
        opt.update(state.opt_state)
        moved = 0
        for name, p in unet.named_parameters():
            got = p.detach().double() - before[name].double()
            np.testing.assert_allclose(got.numpy(), want[name].double().numpy(), rtol=0,
                                       atol=1e-7, err_msg=name)
            moved += bool(got.abs().max() > 0)
        assert moved == sum(".fuser." in n for n in want)


def test_three_steps_match_jax(setup):
    unet_j, params, batch, alphas = setup
    lr, steps = 1e-4, 3
    jmask = jtrain.gligen_adapter_mask(params)
    jopt = jtrain.make_optimizer(lr, trainable_mask=jmask)
    jstep = jax.jit(jtrain.make_train_step(unet_j, jopt, jnp.asarray(alphas), objs_fn=_objs))
    jstate = jtrain.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jlosses = []
    for _ in range(steps):
        jstate, loss = jstep(jstate, jbatch)
        jlosses.append(float(loss))
    want = convert.state_dict_from_tree(jax.tree_util.tree_map(np.asarray, jstate.params))

    with one_torch_thread():
        unet = _port_unet(params)
        opt = ttrain.make_optimizer(lr, trainable_mask=ttrain.gligen_adapter_mask(unet))
        step = ttrain.make_train_step(unet, opt, alphas, objs_fn=_objs)
        state = ttrain.init_train_state(unet, opt)
        tbatch = _port_batch(batch)
        losses = []
        for _ in range(steps):
            state, loss = step(state, tbatch)
            losses.append(float(loss))
    assert state.step == steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    before = convert.state_dict_from_tree(params)
    n_far = n_all = 0
    for name, p in unet.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        if ".fuser." not in name:
            np.testing.assert_array_equal(got, before[name].numpy(), err_msg=name)
            continue
        diff = np.abs(got - w)
        assert diff.max() <= 2 * lr * steps, name
        n_far += int((diff > 1e-6).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def test_adapter_mask_matches_jax(setup):
    _, params, _, _ = setup
    unet = _port_unet(params)
    mask = ttrain.gligen_adapter_mask(unet)
    assert set(mask) == {n for n, _ in unet.named_parameters()}
    want = _mask_names(jtrain.gligen_adapter_mask(params), params)
    assert {n for n, on in mask.items() if on} == want
    assert want and all(".fuser." in n for n in want)
    # The position_net segment selects a PositionNet's parameters too.
    pn = torch.nn.ModuleDict({"position_net": torch.nn.Linear(2, 2),
                              "other": torch.nn.Linear(2, 2)})
    assert ttrain.gligen_adapter_mask(pn) == {
        "position_net.weight": True, "position_net.bias": True,
        "other.weight": False, "other.bias": False}


def test_checkpoint_round_trip(setup, tmp_path):
    _, params, batch, alphas = setup
    tbatch = _port_batch(batch)
    with one_torch_thread():
        unet = _port_unet(params)
        opt = ttrain.make_optimizer(1e-3, trainable_mask=ttrain.gligen_adapter_mask(unet))
        step = ttrain.make_train_step(unet, opt, alphas, objs_fn=_objs)
        state, _ = step(ttrain.init_train_state(unet, opt), tbatch)
        path = str(tmp_path / "step_1")
        tckpt.save(path, state)

        # A template of the same structure on other weights and a fresh
        # optimizer.
        other = tmodels.build_train_unet(tconfig.SD_CONFIGS["tiny-test"](), seed=3,
                                         device="cpu")
        template = ttrain.init_train_state(other, opt)
        restored = tckpt.restore(path, template)
        assert restored.step == 1 and restored.params is other
        for (name, a), (_, b) in zip(unet.state_dict().items(), other.state_dict().items()):
            assert torch.equal(a, b), name
        names = {id(p): n for n, p in other.named_parameters()}
        saved = {names[id(p)]: s for p, s in restored.opt_state.state.items()}
        orig = dict(zip((n for n, _ in unet.named_parameters()), unet.parameters()))
        assert len(saved) == len(state.opt_state.state) > 0
        for name, s in saved.items():
            for key, value in state.opt_state.state[orig[name]].items():
                assert torch.equal(torch.as_tensor(s[key]), torch.as_tensor(value)), (name, key)
        assert restored.opt_state.param_groups[0]["lr"] == 1e-3

        # Both states take the same next step.
        _, loss_a = step(state, tbatch)
        step_b = ttrain.make_train_step(other, opt, alphas, objs_fn=_objs)
        _, loss_b = step_b(restored, tbatch)
    assert float(loss_a) == float(loss_b)
    for (name, a), (_, b) in zip(unet.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), name
    assert tckpt.latest_step_dir(str(tmp_path)) == path


def test_latest_step_dir_matches_jax(tmp_path):
    for name in ("step_2", "step_10", "step_9", "other", "step_1"):
        os.makedirs(tmp_path / "run" / name)
    root = str(tmp_path / "run")
    assert tckpt.latest_step_dir(root) == jckpt.latest_step_dir(root) == \
        os.path.join(root, "step_10")
    os.makedirs(tmp_path / "empty")
    for missing in (str(tmp_path / "empty"), str(tmp_path / "absent")):
        assert tckpt.latest_step_dir(missing) is jckpt.latest_step_dir(missing) is None
