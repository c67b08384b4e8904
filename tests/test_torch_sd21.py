"""The port on SD2.1 base (`--use-sdv2`) against the JAX package, at an
SD2-shaped tiny configuration on the same weights.

The configuration is tiny-test changed as SD2.1 differs from SD1.x, the
same on both sides (`dataclasses.replace`; it belongs to this file and to
neither package): linear projections in and out of each transformer, heads
per level (2, 4) so that the head dim is 16 at both levels, as SD2.1's is 64
at every level, no GLIGEN, and a text tower with ViT-H's fields (exact GELU,
the last hidden state after the final LayerNorm) whose width (48) is the
cross-attention width. Weights: `tests/_torch_tiny.py` (shapes from
`jax.eval_shape`, values from numpy, carried across by
`convert.from_jax_params`); the JAX side draws its noise with torch
(LMDX_NOISE_BACKEND=torch) as the port does; the port runs on one torch
thread.

Tolerances, as shares of the largest value: the tower's hidden state and
pooled embedding 1e-5; the UNet's eps 1e-4; the latents each package hands
its VAE 1e-4; uint8 images within 1 level. The full-size SD2.1 against its
copied manifests, on `meta`, is a case of
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
from lmdx_torch.nn import clip as tclip
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels
from tests._torch_tiny import one_torch_thread, record_decodes, tiny_bundles

SD21 = "stabilityai/stable-diffusion-2-1-base"
SPECS = [
    {"prompt": "A realistic scene with a red cube and a blue ball",
     "gen_boxes": [("a red cube", (50, 300, 120, 120)),
                   ("a blue ball", (300, 280, 100, 100))],
     "bg_prompt": "A realistic scene", "extra_neg_prompt": ""},
    {"prompt": "A park with a green tree and a red bench",
     "gen_boxes": [("a green tree", (200, 100, 150, 250)),
                   ("a red bench", (20, 350, 160, 100))],
     "bg_prompt": "A park", "extra_neg_prompt": "people"},
]
OVERRIDES = dict(max_iter=1, overall_max_iter=1, max_index_step=2,
                 overall_max_index_step=2, num_inference_steps=5)


def sd2_shaped(cfg):
    """tiny-test (either package's) changed as SD2.1 differs from SD1.x."""
    return dataclasses.replace(
        cfg, key="tiny-sd2",
        unet=dataclasses.replace(cfg.unet, num_attention_heads=(2, 4), cross_attention_dim=48,
                                 use_linear_projection=True, use_gligen=False),
        clip=dataclasses.replace(cfg.clip, hidden_size=48, intermediate_size=192,
                                 num_heads=3, hidden_act="gelu"))


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles(seed=5, configs=(sd2_shaped(jconfig.tiny_test()),
                                            sd2_shaped(tconfig.tiny_test())))


@pytest.fixture
def torch_noise(monkeypatch):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _images_close(got, want, levels=1):
    want = np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= levels
    assert got.std() > 0


def test_sd21_config_is_sd2_shaped():
    """What the tiny configuration stands for: SD2.1's head dim is 64 at
    every level, its tower ViT-H's last hidden state, as wide as the
    cross-attention."""
    cfg = tconfig.SD_CONFIGS[SD21]()
    u = cfg.unet
    assert {u.head_dim(c, i) for i, c in enumerate(u.block_out_channels)} == {64}
    assert u.use_linear_projection and not u.use_gligen and not cfg.clip2
    assert cfg.clip.hidden_act == "gelu" and not cfg.clip.penultimate_hidden
    assert cfg.context_dim == u.cross_attention_dim == cfg.clip.hidden_size == 1024
    tiny = sd2_shaped(tconfig.tiny_test())
    assert {tiny.unet.head_dim(c, i) for i, c in enumerate(tiny.unet.block_out_channels)} == {16}
    assert tiny.context_dim == tiny.unet.cross_attention_dim


def test_vit_h_tower_matches_jax():
    """ViT-H's field set (exact GELU, the last hidden state after the final
    LayerNorm, the pooled EOS embedding unprojected) at 3 layers and width
    48: hidden state and pooled embedding within 1e-5."""
    full = tconfig.SD_CONFIGS[SD21]().clip
    fields = dict(vocab_size=1024, hidden_size=48, intermediate_size=192, num_layers=3,
                  num_heads=3)
    cfg = dataclasses.replace(full, **fields)
    jcfg = dataclasses.replace(jconfig.SD_CONFIGS[SD21]().clip, **fields)
    jmod = jclip.CLIPTextEncoder(jcfg)
    ids = np.random.default_rng(9).integers(0, 999, (3, 77)).astype(np.int32)
    ids[:, 11], ids[2, 5] = 1000, 1000
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), jnp.asarray(ids)))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda x: rng.normal(0.0, 0.3, x.shape).astype(np.float32), shapes)
    want_h, want_p = jmod.apply({"params": params}, jnp.asarray(ids), eos_token_id=1000)
    tmod = tclip.CLIPTextEncoder(cfg)
    tmod.load_state_dict(convert.state_dict_from_tree(params), strict=True)
    with torch.no_grad(), one_torch_thread():
        got_h, got_p = tmod(torch.from_numpy(ids).long(), eos_token_id=1000)
    _close(got_h, want_h, 1e-5)
    _close(got_p, want_p, 1e-5)
    # The last state, not the penultimate one that the SDXL towers take.
    tmod.config = dataclasses.replace(cfg, penultimate_hidden=True)
    with torch.no_grad(), one_torch_thread():
        penultimate, _ = tmod(torch.from_numpy(ids).long(), eos_token_id=1000)
    assert (penultimate - got_h).abs().max() > 0.1 * got_h.abs().max()


def test_unet_matches_jax(bundles):
    jb, tb = bundles
    rng = np.random.default_rng(12)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([801.0, 95.5], np.float32)
    ctx = rng.standard_normal((2, 77, 48)).astype(np.float32)
    want, _ = japply_unet(jb.unet, jb.params["unet"], jnp.asarray(lat), jnp.asarray(t),
                          jnp.asarray(ctx))
    with torch.no_grad(), one_torch_thread():
        got = tb.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("spec", SPECS, ids=["layout_a", "layout_b"])
def test_lmd_matches_jax(monkeypatch, bundles, torch_noise, spec):
    jb, tb = bundles
    want_latents, got_latents = record_decodes(monkeypatch, jbase, tbase)
    want = jmethods.get_method("lmd").run(spec, jb, **OVERRIDES)
    with one_torch_thread():
        got = tmethods.get_method("lmd").run(spec, tb, **OVERRIDES)
    assert len(got_latents) == len(want_latents) == 2
    for g, w in zip(got_latents, want_latents):
        _close(g, w, 1e-4)
    _images_close(got.image, want.image)
    np.testing.assert_array_equal(got.aux["frozen_mask"], want.aux["frozen_mask"])
    assert got.aux["frozen_mask"].sum() > 0
    for gm, wm in zip(got.aux["masks"], want.aux["masks"]):
        np.testing.assert_array_equal(gm, np.asarray(wm))
    for gi, wi in zip(got.so_img_list, want.so_img_list):
        _images_close(gi, wi)


def test_run_lmd_batch_matches_jax(monkeypatch, bundles, torch_noise):
    jb, tb = bundles
    want_latents, got_latents = record_decodes(monkeypatch, jbase, tbase)
    want = jbatch.run_lmd_batch(SPECS, jb, bg_seeds=[1, 2], **OVERRIDES)
    with one_torch_thread():
        got = tbatch.run_lmd_batch(SPECS, tb, bg_seeds=[1, 2], **OVERRIDES)
    assert len(got_latents) == len(want_latents) > 0
    for g, w in zip(got_latents, want_latents):
        _close(g, w, 1e-4)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _images_close(g.image, w.image)
        np.testing.assert_array_equal(g.aux["frozen_mask"], w.aux["frozen_mask"])
    assert (got[0].image != got[1].image).any()


@pytest.mark.parametrize("name", ["sd", "boxdiff"])
def test_baseline_matches_jax(monkeypatch, bundles, torch_noise, name):
    jb, tb = bundles
    want_latents, got_latents = record_decodes(monkeypatch, jbase, tbase)
    kw = dict(bg_seed=3, num_inference_steps=6)
    if name == "boxdiff":
        kw["overall_max_index_step"] = 2
    want = jmethods.get_method(name).run(SPECS[0], jb, **kw)
    with one_torch_thread():
        got = tmethods.get_method(name).run(SPECS[0], tb, **kw)
    assert len(got_latents) == len(want_latents) == 1
    _close(got_latents[0], want_latents[0], 1e-4)
    _images_close(got.image, want.image)


# ---- the CLI's --use-sdv2 -------------------------------------------------------

# The first two demo prompts (2 boxes and 1).
RESPONSES = (
    "Objects: [('a blue cube', [232, 135, 132, 132]), ('a vase', [80, 250, 90, 160])]"
    "\nBackground prompt: An indoor scene\nNegative prompt: ",
    "Objects: [('a wooden table', [60, 250, 392, 200])]\nBackground prompt: A realistic "
    "photo of an indoor scene\nNegative prompt: bananas",
)


@pytest.mark.parametrize("mode", [[], ["--image-batch-size", "2"]], ids=["sequential", "batched"])
def test_cli_use_sdv2_pngs_match_jax(bundles, torch_noise, mode, tmp_path, monkeypatch):
    """`--use-sdv2 --run-model lmd` on both CLIs, each `load_bundle` a recorder
    that hands back its package's SD2-shaped tiny bundle: the same model key,
    the same PNG files, each image within 1 level."""
    monkeypatch.setattr(jit_cache, "enable", lambda *a, **k: None)
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR", raising=False)
    cache = tmp_path / "cache_demo_v0.1_gpt-4.json"
    cache.write_text(json.dumps({p.strip().rstrip("."): [r]
                                 for p, r in zip(PROMPTS_DEMO, RESPONSES)}))
    jb, tb = bundles
    keys = {}
    for name, gen, models, bundle in (("jax", jgen, jmodels, jb), ("torch", tgen, tmodels, tb)):
        seen = keys[name] = []

        def load_bundle(key, _seen=seen, _bundle=bundle, **kw):
            _seen.append((key, kw.get("dtype")))
            return _bundle

        monkeypatch.setattr(models, "load_bundle", load_bundle)
        argv = ["--prompt-type", "demo", "--run-model", "lmd", "--use-sdv2",
                "--num_prompts", "2", "--cache-path", str(cache),
                "--save-dir", str(tmp_path / name), "--force_run_ind", "0",
                "--num_inference_steps", "4", "--max_iter", "1", "--overall_max_iter", "1",
                "--max_index_step", "2", "--overall_max_index_step", "2",
                "--no-continue-on-error", *mode]
        with one_torch_thread():
            assert gen.main(argv + (["--cpu"] if name == "torch" else [])) == 0
    assert keys["torch"] == keys["jax"] == [(SD21, None)]
    j_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    t_files = sorted(p.relative_to(tmp_path / "torch")
                     for p in (tmp_path / "torch").rglob("*.png"))
    assert t_files == j_files
    imgs = [rel for rel in t_files if rel.name == "img_0.png"]
    assert len(imgs) == 2
    for rel in imgs:
        _images_close(np.asarray(Image.open(tmp_path / "torch" / rel)),
                      np.asarray(Image.open(tmp_path / "jax" / rel)))
