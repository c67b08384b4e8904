"""The port's SDXL base bundle (two text towers, the feature concat of their
penultimate states as the UNet context, the pooled vector from the second
tower's projection, text_time on 6 ids, DDIM) against the JAX package's, at
`tiny-sdxl-base` on the same weights (`tests/_torch_tiny.py`), with the JAX
side's noise drawn by torch (LMDX_NOISE_BACKEND=torch) as the port draws it.

Tolerances, as shares of the largest value: `encode_text`'s hidden state
(N, 77, 16 + 32) and pooled embedding 1e-5; `img2img`'s final latents 1e-4;
`refine`'s and the CLI's uint8 images within 1 level; a fabricated
checkpoint loads bit for bit as the JAX loader loads it. The full-size SDXL
base against its copied manifests (both towers), on `meta`, is a case of
`tests/test_torch_checkpoint.py::test_full_size_modules_match_the_manifests`.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from lmdx import methods as jmethods
from lmdx.cli import generate as jgen
from lmdx.methods import base as jbase
from lmdx.methods import batch as jbatch
from lmdx.methods import sdxl_refine as jsdxl
from lmdx.runtime import jit_cache
from lmdx.runtime import models as jmodels
from lmdx_torch import config as tconfig
from lmdx_torch import methods as tmethods
from lmdx_torch.cli import generate as tgen
from lmdx_torch.eval.prompts import PROMPTS_DEMO
from lmdx_torch.methods import base as tbase
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.methods import sdxl_refine as tsdxl
from lmdx_torch.runtime import convert, fabricate
from lmdx_torch.runtime import models as tmodels
from tests._torch_tiny import one_torch_thread, tiny_bundles
from tests.test_torch_sdxl_refiner import _close, _image, _record

KEY = "tiny-sdxl-base"
PROMPTS = ["a red cube", "a park", "a photo of a cat on a sofa"]


@pytest.fixture(scope="module")
def bundles():
    jb, tb = tiny_bundles(seed=4, key=KEY)
    with one_torch_thread():
        yield jb, tb


@pytest.fixture
def torch_noise(monkeypatch):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")


def test_random_bundle_has_both_towers():
    with one_torch_thread():
        b = tmodels.load_bundle(KEY, device="cpu")
    cfg = b.config
    assert b.text_encoder_2 is not None and b.text_encoder_2.config == cfg.clip2
    assert cfg.context_dim == cfg.unet.cross_attention_dim == 48 and cfg.pooled_dim == 32
    assert cfg.default_scheduler == "ddim"
    one = tmodels.load_bundle("tiny-sdxl", device="cpu")
    assert one.text_encoder_2 is None


def test_encode_text_matches_jax(bundles):
    jb, tb = bundles
    want_h, want_p = jmodels.encode_text(jb, PROMPTS)
    got_h, got_p = tmodels.encode_text(tb, PROMPTS)
    assert tuple(got_h.shape) == (3, 77, 48) and tuple(got_p.shape) == (3, 32)
    _close(got_h, want_h, 1e-5)
    _close(got_p, want_p, 1e-5)
    # The pooled vector is the second tower's projected embedding.
    ids = torch.tensor([tb.tokenizer.encode(p, pad_to=77) for p in PROMPTS]) % 1024
    with torch.no_grad():
        _, pooled2 = tb.text_encoder_2(ids, eos_token_id=tb.tokenizer.eos_id % 1024)
    _close(got_p, pooled2, 1e-6)


def test_each_half_of_the_concat_varies_across_prompts(bundles):
    _, tb = bundles
    hidden, _ = tmodels.encode_text(tb, PROMPTS[:2])
    assert (hidden[0, :, :16] - hidden[1, :, :16]).abs().max() > 0
    assert (hidden[0, :, 16:] - hidden[1, :, 16:]).abs().max() > 0


def test_img2img_latents_match_jax(bundles, torch_noise):
    """On the base's own scheduler (DDIM) with its 6 time ids."""
    jb, tb = bundles
    image = _image(23, 32)
    kw = dict(strength=0.5, num_inference_steps=8, seed=31, return_latents=True,
              negative_prompt="blurry")
    want = jsdxl.img2img(jb, image, "a green car", **kw)
    got = tsdxl.img2img(tb, image, "a green car", **kw)
    _close(got, want, 1e-4)


def test_refine_matches_jax(bundles, torch_noise):
    jb, tb = bundles
    image, spec = _image(19, 16), {"prompt": "a cat", "extra_neg_prompt": "dogs"}
    want = jsdxl.refine(image, spec, refine_seed=3, refinement_step_ratio=0.5, bundle=jb)
    got = tsdxl.refine(image, spec, refine_seed=3, refinement_step_ratio=0.5, bundle=tb)
    assert got.dtype == np.uint8 and got.shape == want.shape == (32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", [[], ["--image-batch-size", "2"]], ids=["sequential", "batched"])
def test_cli_sdxl_base_pngs_match_jax(bundles, torch_noise, mode, tmp_path, monkeypatch):
    """`--sdxl` with LMDX_REFINER_MODEL=tiny-sdxl-base on both CLIs (stage 2
    by recorders, the refiner bundle each package's tiny SDXL base): the PNGs
    agree within 1 level and are the refiner's, not the LANCZOS upscale."""
    monkeypatch.setattr(jit_cache, "enable", lambda *a, **k: None)
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR", raising=False)
    monkeypatch.setenv("LMDX_REFINER_MODEL", KEY)
    cache = tmp_path / "cache_demo_v0.1_gpt-4.json"
    cache.write_text(json.dumps({PROMPTS_DEMO[0].strip().rstrip("."): [
        "Objects: [('a gray cat', [100, 200, 250, 200])]\nBackground prompt: A realistic "
        "photo of a sofa\nNegative prompt: dogs"]}))
    jb, tb = bundles
    pngs = {}
    for name, side, refiner, result_cls in (
            ("jax", (jgen, jmodels, jmethods, jbatch, jsdxl), jb, jbase.GenerationResult),
            ("torch", (tgen, tmodels, tmethods, tbatch, tsdxl), tb, tbase.GenerationResult)):
        _record(monkeypatch, side, refiner, result_cls, refiner_key=KEY)
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


def test_load_refiner_bundle_reads_the_variable(monkeypatch):
    monkeypatch.setenv("LMDX_REFINER_MODEL", KEY)
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR", raising=False)
    monkeypatch.setattr(tsdxl, "_REFINER_CACHE", {})
    with one_torch_thread():
        b = tsdxl.load_refiner_bundle("cpu")
    assert b.config.key == KEY and b.text_encoder_2 is not None
    assert tsdxl.load_refiner_bundle("cpu") is b


# ---- a fabricated checkpoint through both loaders ---------------------------------

def _legacy_vae(key: str) -> str:
    for new, old in convert._VAE_ERA_RENAMES.items():
        key = key.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
    return key


def test_fabricated_checkpoint_loads_like_jax(tmp_path, monkeypatch):
    """Manifests of tiny-sdxl-base (the port's module names and shapes, the
    VAE in the published legacy names) -> `fabricate.fabricate_model` (fp16,
    `text_encoder/` and `text_encoder_2/`) -> `validate_checkpoint` clean ->
    the port's `load_bundle` and the JAX package's: every value equal bit
    for bit (at bfloat16, the JAX value cast to the port's dtype), at
    float32 and at bfloat16."""
    cfg = tconfig.SD_CONFIGS[KEY]()
    with torch.device("meta"):
        parts = tmodels.build_modules(cfg)
    manifests = tmp_path / "manifests"
    manifests.mkdir()
    names = {"unet": "unet", "text_encoder": "text", "text_encoder_2": "text2", "vae": "vae"}
    for component, part in names.items():
        shapes = {(_legacy_vae(k) if part == "vae" else k): list(v.shape)
                  for k, v in parts[part].state_dict().items()}
        (manifests / f"tiny_{component}.json").write_text(json.dumps(shapes))
    monkeypatch.setattr(convert, "MANIFEST_DIR", str(manifests))
    monkeypatch.setitem(convert._COMPONENT_MANIFESTS, KEY,
                        {c: f"tiny_{c}" for c in names})
    n = fabricate.fabricate_model(KEY, str(tmp_path), torch.float16)
    ckpt = str(tmp_path / KEY)
    assert sorted(p.name for p in (tmp_path / KEY).iterdir()) == sorted(names)
    report = convert.validate_checkpoint(KEY, ckpt)
    assert all(r == {"missing": [], "extra": [], "shape": []} for r in report.values())
    for dtype in (None, "bfloat16"):
        jb = jmodels.load_bundle.__wrapped__(KEY, ckpt, dtype=dtype)
        want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jb.params), cfg)
        tb = tmodels.load_bundle(KEY, ckpt, dtype=dtype, device="cpu")
        got = {"unet": tb.unet, "text": tb.text_encoder, "vae": tb.vae,
               "text2": tb.text_encoder_2}
        assert sorted(got) == sorted(want)
        total = 0
        for part, module in got.items():
            sd = module.state_dict()
            assert sorted(sd) == sorted(want[part])
            for k, t in sd.items():
                # The JAX loader keeps the file's fp16 and casts at each
                # use; the port stores the cast: the same values.
                assert torch.equal(t, want[part][k].to(t.dtype)), (part, k)
                total += t.numel()
        assert total == n
