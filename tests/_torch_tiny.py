"""The tiny-test bundles of both packages on the same weights, for the
port's parity tests of the single-image methods.

The JAX package's `load_bundle` compiles its whole random init (~25 s on
the CPU). Here the parameter tree's shapes come from `jax.eval_shape` of
that init, which compiles nothing, and the values from a seeded numpy
generator by Flax's default rules: kernels N(0, 1/fan_in), biases zero,
norm scales one, the token embedding N(0, 1/width), the position embedding
N(0, 0.01^2). Flax inits the GLIGEN gates and null features to zero, which
makes every fuser a no-op; here the gates are 0.7 (attention) and -0.4
(dense) and the null features N(0, 0.5^2), as the repo's parity tests set
them, so the grounding reaches the image. The port's bundle takes the same
weights through `convert.from_jax_params`.

`record_decodes` keeps the latents each package hands its VAE, so a test
can hold the sampling passes' results at f32 where the tiny VAE's uint8
images would hide a difference of a few thousandths.

`one_torch_thread` runs the port on one intra-op thread: its tensors are
tiny, and with several test workers on few cores the idle threads' waits
multiply the run time.
"""

import contextlib

import jax
import numpy as np
import torch

from lmdx.runtime import models as jmodels
from lmdx.text import tokens as jtok
from lmdx_torch import config as tconfig
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels


def _value(path, leaf, rng):
    name = path[-1].key
    shape = leaf.shape
    if name == "bias":
        return np.zeros(shape, np.float32)
    if name in ("alpha_attn", "alpha_dense"):
        return np.full(shape, 0.7 if name == "alpha_attn" else -0.4, np.float32)
    if name in ("null_position_feature", "null_positive_feature"):
        return rng.normal(0.0, 0.5, shape).astype(np.float32)
    if name == "scale":
        return np.ones(shape, np.float32)
    if name == "embedding":
        return rng.normal(0.0, shape[1] ** -0.5, shape).astype(np.float32)
    if name == "position_embedding":
        return rng.normal(0.0, 0.01, shape).astype(np.float32)
    if name == "kernel":
        return rng.normal(0.0, np.prod(shape[:-1]) ** -0.5, shape).astype(np.float32)
    raise ValueError(f"no init rule for {'/'.join(p.key for p in path)}")


def tiny_params(seed: int = 0, config=None):
    """The JAX parameter tree (numpy leaves) of `config` (default tiny-test),
    drawn by the rules above."""
    config = config or jmodels.SD_CONFIGS["tiny-test"]()
    shapes = jax.eval_shape(lambda: jmodels.init_random_params(config, seed=seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, x: _value(p, x, rng), shapes)


def tiny_bundles(seed: int = 0):
    """(JAX bundle, port bundle on the CPU) of the tiny-test config."""
    config = jmodels.SD_CONFIGS["tiny-test"]()
    params = tiny_params(seed, config)
    unet, text_encoder, vae, position_net = jmodels.build_modules(config)
    jb = jmodels.ModelBundle(
        config=config, tokenizer=jtok.default_tokenizer(), unet=unet,
        text_encoder=text_encoder, vae=vae, position_net=position_net,
        params=jax.device_put(params),
        text_encoder_2=jmodels.build_text_encoder_2(config))
    tcfg = tconfig.tiny_test()
    tb = tmodels.build_bundle(tcfg, convert.from_jax_params(params, tcfg), device="cpu")
    return jb, tb


def record_decodes(monkeypatch, *base_modules):
    """Wrap each package's `methods.base.decode_latents`; returns one list
    per module of the float32 latents it was given, in call order."""
    records = []
    for module in base_modules:
        seen, decode = [], module.decode_latents

        def wrapped(bundle, latents, *args, _decode=decode, _seen=seen, **kwargs):
            x = latents.detach().cpu().numpy() if torch.is_tensor(latents) else latents
            _seen.append(np.asarray(x, np.float32))
            return _decode(bundle, latents, *args, **kwargs)

        monkeypatch.setattr(module, "decode_latents", wrapped)
        records.append(seen)
    return records


@contextlib.contextmanager
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
