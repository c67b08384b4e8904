"""The port's SDXL refiner (`lmdx_torch.methods.sdxl_refine`, the text_time
UNet, the OpenCLIP tower, the Euler sampler, `cli.generate --sdxl`) against
the JAX package's, at `tiny-sdxl` on the same weights (`tests/_torch_tiny.py`:
shapes from `jax.eval_shape`, values from numpy, carried across by
`convert.from_jax_params`), with the JAX side's noise drawn by torch
(LMDX_NOISE_BACKEND=torch) as the port draws it.

Tolerances, as shares of the largest value: the CLIP tower's hidden state
and pooled embedding 1e-5; the UNet's eps (text_time, linear projections,
transformer depths (1, 2)) 1e-4; `img2img`'s final latents on Euler and on
DDIM 1e-4; `refine`'s and the CLI's uint8 images within 1 level. The
full-size refiner against its copied manifests, on `meta`, is a case of
`tests/test_torch_checkpoint.py::test_full_size_modules_match_the_manifests`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmdx import config as jconfig
from lmdx import methods as jmethods
from lmdx.cli import generate as jgen
from lmdx.methods import base as jbase
from lmdx.methods import batch as jbatch
from lmdx.methods import sdxl_refine as jsdxl
from lmdx.nn import clip as jclip
from lmdx.nn.unet import apply_unet as japply_unet
from lmdx.runtime import jit_cache
from lmdx.runtime import models as jmodels
from lmdx_torch import config as tconfig
from lmdx_torch import methods as tmethods
from lmdx_torch.cli import generate as tgen
from lmdx_torch.eval.prompts import PROMPTS_DEMO
from lmdx_torch.methods import base as tbase
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.methods import sdxl_refine as tsdxl
from lmdx_torch.nn import clip as tclip
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels
from tests._torch_tiny import one_torch_thread, tiny_bundles

REFINER = "stabilityai/stable-diffusion-xl-refiner-1.0"


@pytest.fixture(scope="module")
def bundles():
    jb, tb = tiny_bundles(seed=3, key="tiny-sdxl")
    with one_torch_thread():
        yield jb, tb


@pytest.fixture
def torch_noise(monkeypatch):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _image(seed, size):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("key", ["tiny-sdxl", REFINER, "stabilityai/stable-diffusion-2-1-base",
                                 "stabilityai/stable-diffusion-xl-base-1.0", "tiny-sdxl-base"])
def test_configs_match_jax(key):
    """The port's configuration carries the JAX one's fields and values (the
    second tower too), and its derived widths."""
    jcfg, tcfg = jconfig.SD_CONFIGS[key](), tconfig.SD_CONFIGS[key]()
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(tcfg)
    want.pop("param_dtype")
    assert got == want
    assert (tcfg.pooled_dim, tcfg.context_dim) == (jcfg.pooled_dim, jcfg.context_dim)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_tower_matches_jax(act):
    """Penultimate hidden state and the projected pooled embedding of the
    tiny-sdxl tower, with its quick GELU and with OpenCLIP's exact GELU."""
    cfg = dataclasses.replace(tconfig.tiny_sdxl().clip, hidden_act=act)
    jcfg = dataclasses.replace(jconfig.tiny_sdxl().clip, hidden_act=act)
    jmod = jclip.CLIPTextEncoder(jcfg)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size - 1, (3, 77)).astype(np.int32)
    ids[:, 9], ids[1, 4] = 1000, 1000
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), jnp.asarray(ids)))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda x: rng.normal(0.0, 0.3, x.shape).astype(np.float32), shapes)
    want_h, want_p = jmod.apply({"params": params}, jnp.asarray(ids), eos_token_id=1000)
    tmod = tclip.CLIPTextEncoder(cfg)
    tmod.load_state_dict(convert.state_dict_from_tree(params), strict=True)
    with torch.no_grad(), one_torch_thread():
        got_h, got_p = tmod(torch.from_numpy(ids).long(), eos_token_id=1000)
    _close(got_h, want_h, 1e-5)
    _close(got_p, want_p, 1e-5)


def test_unet_with_text_time_matches_jax(bundles):
    jb, tb = bundles
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([731.5, 212.25], np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 32)).astype(np.float32)
    ids = np.asarray([[32, 32, 0, 0, 2.5], [32, 32, 0, 0, 6.0]], np.float32)
    want, _ = japply_unet(jb.unet, jb.params["unet"], jnp.asarray(lat), jnp.asarray(t),
                          jnp.asarray(ctx), added_text_embeds=jnp.asarray(pooled),
                          added_time_ids=jnp.asarray(ids))
    with torch.no_grad():
        got = tb.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                      added_text_embeds=torch.from_numpy(pooled),
                      added_time_ids=torch.from_numpy(ids))
    _close(got, want, 1e-4)
    # The conditioning reaches eps.
    with torch.no_grad():
        other = tb.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                        added_text_embeds=torch.from_numpy(pooled),
                        added_time_ids=torch.from_numpy(ids[::-1].copy()))
    assert (other - got).abs().max() > 1e-3 * got.abs().max()


@pytest.mark.parametrize("scheduler", ["euler", "ddim"])
def test_img2img_latents_match_jax(bundles, torch_noise, scheduler):
    jb, tb = bundles
    image = _image(13, 32)
    kw = dict(strength=0.5, num_inference_steps=8, seed=21, return_latents=True,
              scheduler=scheduler, negative_prompt="blurry")
    want = jsdxl.img2img(jb, image, "a red car on a road", **kw)
    got = tsdxl.img2img(tb, image, "a red car on a road", **kw)
    _close(got, want, 1e-4)


def test_refine_matches_jax(bundles, torch_noise):
    jb, tb = bundles
    image, spec = _image(17, 16), {"prompt": "a cat", "extra_neg_prompt": "dogs"}
    want = jsdxl.refine(image, spec, refine_seed=40, bundle=jb)
    got = tsdxl.refine(image, spec, refine_seed=40, bundle=tb)
    assert got.dtype == np.uint8 and got.shape == want.shape == (32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class _Bundle:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.checkpoint_dir = None


def _record(monkeypatch, side, refiner, result_cls, refiner_key="tiny-sdxl"):
    """Stage 2 by recorders (each image a seeded 16x16 one); the refiner
    bundle of LMDX_REFINER_MODEL (`refiner_key`) is `refiner`, the stage-2
    one a stub."""
    gen, models, methods, batch, sdxl = side

    def load_bundle(key, **kw):
        return refiner if key == refiner_key else _Bundle(refiner.tokenizer)

    class Method:
        def __init__(self, name):
            pass

        def run(self, spec, bundle, bg_seed, **kw):
            return result_cls(image=_image(bg_seed, 16))

    def batch_fn(specs, bundle, **kw):
        return [result_cls(image=_image(s, 16)) for s in kw["bg_seeds"]]

    monkeypatch.setattr(models, "load_bundle", load_bundle)
    monkeypatch.setattr(methods, "get_method", Method)
    monkeypatch.setattr(batch, "run_lmd_plus_batch", batch_fn)
    monkeypatch.setattr(sdxl, "_REFINER_CACHE", {})


@pytest.mark.parametrize("mode", [[], ["--image-batch-size", "2"]], ids=["sequential", "batched"])
def test_cli_sdxl_pngs_match_jax(bundles, torch_noise, mode, tmp_path, monkeypatch):
    """`--sdxl` on a one-layout cache with LMDX_REFINER_MODEL=tiny-sdxl: both
    CLIs refine after the method, before the PNG is written, with seed +
    LARGE_CONSTANT4; the PNGs agree within 1 level and are the refiner's,
    not the LANCZOS upscale."""
    monkeypatch.setattr(jit_cache, "enable", lambda *a, **k: None)
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR", raising=False)
    monkeypatch.setenv("LMDX_REFINER_MODEL", "tiny-sdxl")
    cache = tmp_path / "cache_demo_v0.1_gpt-4.json"
    cache.write_text(json.dumps({PROMPTS_DEMO[0].strip().rstrip("."): [
        "Objects: [('a gray cat', [100, 200, 250, 200])]\nBackground prompt: A realistic "
        "photo of a sofa\nNegative prompt: dogs"]}))
    jb, tb = bundles
    pngs = {}
    for name, side, refiner, result_cls in (
            ("jax", (jgen, jmodels, jmethods, jbatch, jsdxl), jb, jbase.GenerationResult),
            ("torch", (tgen, tmodels, tmethods, tbatch, tsdxl), tb, tbase.GenerationResult)):
        _record(monkeypatch, side, refiner, result_cls)
        argv = ["--prompt-type", "demo", "--run-model", "lmd_plus", "--cache-path", str(cache),
                "--save-dir", str(tmp_path / name), "--sdxl", "--no-continue-on-error", *mode]
        assert side[0].main(argv + (["--cpu"] if name == "torch" else [])) == 0
        (path,) = (tmp_path / name).rglob("img_0.png")
        pngs[name] = np.asarray(Image.open(path))
    got, want = pngs["torch"], pngs["jax"]
    assert got.shape == want.shape == (32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    upscaled = np.asarray(Image.fromarray(_image(0, 16)).resize((32, 32), Image.LANCZOS))
    assert np.abs(got.astype(int) - upscaled.astype(int)).max() > 8
