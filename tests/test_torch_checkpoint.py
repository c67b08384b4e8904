"""Checkpoint loading in the port (`lmdx_torch/runtime/{safetensors_io,
convert,models,fabricate}.py`) held against the JAX package's loader on the
same directories, on the CPU.

The directories are written here from the tiny-test parameter tree of
`tests/_torch_tiny.py` (seeded numpy values) under the port's names
(`convert.from_jax_params`), with GLIGEN's `position_net.*` inside the UNet's
file, as diffusers stores it. Loaded parameters are compared bit for bit:
both packages cast f32 to bf16 with round-to-nearest-even. One LMD+ batch on
the loaded bundles is held to `tests/test_torch_slice.py`'s tolerance.

The JAX loader cannot read the legacy VAE files whose attention weights are
(C, C, 1, 1): its `_linear` transposes them as 2-D before its 4-D branch is
reached (`lmdx/runtime/convert.py:60`, `:251`; a ValueError). The port
reads them; its result is held against the JAX load of the same values
stored as (C, C).

Production shapes are checked without allocating: the port's full-size
modules are built on the `meta` device and compared with its manifests.
"""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx import config as jconfig
from lmdx.methods.batch import run_lmd_plus_batch as jax_run
from lmdx.nn import sam as jsam
from lmdx.runtime import convert as jconvert
from lmdx.runtime import models as jmodels
from lmdx.text import tokens as jtok
from lmdx_torch import config as tconfig
from lmdx_torch.methods.batch import run_lmd_plus_batch as torch_run
from lmdx_torch.nn import sam as tsam
from lmdx_torch.runtime import convert, fabricate, safetensors_io
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.text import tokens as ttok
from tests._torch_tiny import one_torch_thread, tiny_params
from tests.test_torch_faults import MERGES, VOCAB
from tests.test_torch_slice import OVERRIDES, SPECS

REPO = Path(__file__).resolve().parents[1]
ERAS = ["modern", "legacy", "legacy_4d"]
MANIFESTS = ["unet_gligen", "unet_sd15", "text_encoder_clip_vit_l", "vae_sd", "sam_vit_base",
             "unet_sdxl_refiner", "text_encoder_clip_bigg", "unet_sd21",
             "text_encoder_clip_vit_h", "unet_sdxl_base"]
# The port's module names -> the manifests' legacy VAE attention names.
LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


# ---- (a) the safetensors format ---------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g),
            "f16": torch.randn(4, 2, 2, generator=g).half(),
            "bf16": torch.randn(7, generator=g).bfloat16(),
            "scalar": torch.tensor(2.640625),  # CLIP's 0-dim logit_scale
            "scalar_bf16": torch.tensor(-0.5, dtype=torch.bfloat16),
            "ids": torch.arange(77, dtype=torch.int64).reshape(1, 77),
            "empty": torch.empty(0, 3)}


@pytest.mark.parametrize("writer", ["port", "package"])
def test_safetensors_round_trip_against_the_package(tmp_path, writer):
    st = pytest.importorskip("safetensors.torch")
    want = _tensors()
    path = str(tmp_path / "x.safetensors")
    if writer == "port":
        safetensors_io.write(want, path, metadata={"format": "pt"})
        got = st.load_file(path)
    else:
        st.save_file(want, path, metadata={"format": "pt"})
        got = safetensors_io.read(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def _raw(path, header, data: bytes):
    raw = json.dumps(header).encode()
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + data)


@pytest.mark.parametrize("case", ["overlap", "overrun", "size", "header_length", "dtype"])
def test_safetensors_reader_refuses_bad_headers(tmp_path, case):
    f32 = {"dtype": "F32", "shape": [2]}
    header = {"overlap": {"a": {**f32, "data_offsets": [0, 8]},
                          "b": {**f32, "data_offsets": [4, 12]}},
              "overrun": {"a": {**f32, "data_offsets": [8, 16]}},
              "size": {"a": {**f32, "data_offsets": [0, 12]}},
              "header_length": {},
              "dtype": {"a": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}}}[case]
    path = tmp_path / "bad.safetensors"
    _raw(path, header, bytes(12))
    if case == "header_length":
        path.write_bytes((10**6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError):
        safetensors_io.read(str(path))


def test_safetensors_reader_maps_the_file(tmp_path):
    path = str(tmp_path / "x.safetensors")
    safetensors_io.write({"w": torch.ones(1024)}, path)
    t = safetensors_io.read(path)["w"]
    t += 1  # copy-on-write: the file keeps its bytes
    assert torch.equal(safetensors_io.read(path)["w"], torch.ones(1024))


# ---- tiny checkpoint directories ---------------------------------------------

def _state_dicts(config=None):
    cfg = config or tconfig.tiny_test()
    jcfg = jmodels.SD_CONFIGS["tiny-test"]()
    if config is not None:
        jcfg = dataclasses.replace(jcfg, clip=dataclasses.replace(
            jcfg.clip, vocab_size=config.clip.vocab_size))
    return convert.from_jax_params(tiny_params(0, jcfg), cfg)


def _vae_file(sd, era):
    if era == "modern":
        return dict(sd)
    out = {}
    for k, v in sd.items():
        for new, old in LEGACY.items():
            marker = f".attentions.0.{new}."
            if marker in k:
                k = k.replace(marker, f".attentions.0.{old}.")
                if era == "legacy_4d" and v.dim() == 2:
                    v = v[:, :, None, None]
                break
        out[k] = v
    return out


def write_checkpoint(root: Path, sds: dict, era: str = "modern") -> str:
    """A diffusers directory of `sds` (the port's names): position_net
    inside the UNet's file, the VAE in the naming era `era`, and the
    `position_ids` buffer older transformers versions save beside CLIP."""
    unet = {**sds["unet"], **{f"position_net.{k}": v for k, v in sds["position_net"].items()}}
    text = {**sds["text"], "text_model.embeddings.position_ids":
            torch.arange(77, dtype=torch.int64)[None]}
    for component, sd in (("unet", unet), ("text_encoder", text),
                          ("vae", _vae_file(sds["vae"], era))):
        (root / component).mkdir(parents=True, exist_ok=True)
        safetensors_io.write(sd, str(root / component / fabricate.FILENAMES[component]))
    return str(root)


@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    sds = _state_dicts()
    root = tmp_path_factory.mktemp("ckpt")
    return sds, {era: write_checkpoint(root / era, sds, era) for era in ERAS}


def _jax_dir(dirs, era):
    """The directory the JAX loader reads for `era` (see the docstring)."""
    return dirs["legacy" if era == "legacy_4d" else era]


def test_jax_loader_refuses_legacy_4d_vae_weights(tiny_dirs):
    """The JAX side's defect that `_jax_dir` works around."""
    with pytest.raises(ValueError):
        jconvert.load_checkpoint(jmodels.SD_CONFIGS["tiny-test"](), tiny_dirs[1]["legacy_4d"])


def _assert_state_dicts_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert torch.equal(g.float(), w.float()), k


# ---- (b) the loader against the JAX package ------------------------------------

@pytest.mark.parametrize("era", ERAS)
def test_load_checkpoint_matches_jax(tiny_dirs, era):
    sds, dirs = tiny_dirs
    cfg = tconfig.tiny_test()
    got = convert.load_checkpoint(cfg, dirs[era])
    want = convert.from_jax_params(
        jconvert.load_checkpoint(jmodels.SD_CONFIGS["tiny-test"](), _jax_dir(dirs, era)), cfg)
    assert sorted(got) == sorted(want) == ["position_net", "text", "unet", "vae"]
    for part in want:
        _assert_state_dicts_equal(got[part], want[part])
        _assert_state_dicts_equal(got[part], sds[part])
        assert all(t.dtype == torch.float32 for t in got[part].values())


def _bundle_params(bundle) -> dict:
    return {"unet": bundle.unet.state_dict(), "text": bundle.text_encoder.state_dict(),
            "vae": bundle.vae.state_dict(), "position_net": bundle.position_net.state_dict()}


def _jax_dtypes(params) -> dict:
    """{part: {port name: True where the JAX leaf is bf16}}."""
    flags = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float(x.dtype == jnp.bfloat16), np.float32), params)
    return {part: {k: bool(v.flatten()[0]) if v.numel() else False for k, v in sd.items()}
            for part, sd in convert.from_jax_params(flags, tconfig.tiny_test()).items()}


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("era", ERAS)
def test_load_bundle_matches_jax_bit_for_bit(tiny_dirs, era, dtype):
    _, dirs = tiny_dirs
    jb = jmodels.load_bundle.__wrapped__("tiny-test", _jax_dir(dirs, era), dtype=dtype)
    params = jax.tree_util.tree_map(np.asarray, jb.params)
    tb = tmodels.load_bundle("tiny-test", dirs[era], dtype=dtype, device="cpu")
    assert tb.checkpoint_dir == dirs[era] and tb.config.dtype == (dtype or "float32")
    got, want = _bundle_params(tb), convert.from_jax_params(params, tconfig.tiny_test())
    bf16 = _jax_dtypes(jb.params)
    for part in want:
        _assert_state_dicts_equal(got[part], want[part])
        for k, t in got[part].items():
            assert (t.dtype == torch.bfloat16) == bf16[part][k], (part, k, t.dtype)
            assert t.dtype in (torch.float32, torch.bfloat16)
    assert any(bf16["unet"].values()) == (dtype == "bfloat16")


def test_lmd_plus_batch_on_loaded_checkpoints_matches_jax(tiny_dirs, monkeypatch):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    _, dirs = tiny_dirs
    jb = jmodels.load_bundle.__wrapped__("tiny-test", dirs["modern"])
    tb = tmodels.load_bundle("tiny-test", dirs["legacy_4d"], device="cpu")
    kw = dict(OVERRIDES, num_inference_steps=6)
    want = jax_run(SPECS, jb, bg_seeds=[1, 2], **kw)
    with one_torch_thread():
        got = torch_run(SPECS, tb, bg_seeds=[1, 2], **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.aux["frozen_mask"], w.aux["frozen_mask"])
        diff = np.abs(g.image.astype(np.int32) - w.image.astype(np.int32))
        assert diff.max() <= 2, diff.max()
    assert (got[0].image != got[1].image).any()


def test_load_checkpoint_refuses_a_gligen_unet_without_position_net(tiny_dirs, tmp_path):
    sds, _ = tiny_dirs
    root = Path(write_checkpoint(tmp_path / "c", sds))
    unet = convert._load_state_dict(str(root / "unet"))
    safetensors_io.write({k: v for k, v in unet.items() if not k.startswith("position_net.")},
                         str(root / "unet" / fabricate.FILENAMES["unet"]))
    with pytest.raises(ValueError, match="position_net"):
        convert.load_checkpoint(tconfig.tiny_test(), str(root))
    with pytest.raises(ValueError, match="position_net"):
        jconvert.load_checkpoint(jmodels.SD_CONFIGS["tiny-test"](), str(root))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_strict_load_refuses_a_mismatched_file(tiny_dirs, tmp_path, fault):
    sds, _ = tiny_dirs
    text = dict(sds["text"])
    name = "text_model.final_layer_norm.bias"
    if fault == "missing":
        del text[name]
    elif fault == "extra":
        text["text_model.unexpected.weight"] = torch.zeros(3)
    else:
        text[name] = torch.zeros(5)
    root = write_checkpoint(tmp_path / "c", {**sds, "text": text})
    with pytest.raises(KeyError, match=fault if fault != "extra" else "unexpected"):
        tmodels.load_bundle("tiny-test", root, device="cpu")


def test_bin_files_load_like_safetensors(tiny_dirs, tmp_path):
    sds, dirs = tiny_dirs
    root = Path(write_checkpoint(tmp_path / "bin", sds))
    for component in ("unet", "text_encoder", "vae"):
        f = root / component / fabricate.FILENAMES[component]
        torch.save(safetensors_io.read(str(f)), root / component /
                   ("pytorch_model.bin" if component == "text_encoder"
                    else "diffusion_pytorch_model.bin"))
        f.unlink()
    got = convert.load_checkpoint(tconfig.tiny_test(), str(root))
    want = convert.load_checkpoint(tconfig.tiny_test(), dirs["modern"])
    for part in want:
        _assert_state_dicts_equal(got[part], want[part])


# ---- (c) validate_checkpoint --------------------------------------------------

def _small_manifests(tmp_path, limit=4096):
    """The manifests cut to their tensors of at most `limit` values, plus the
    VAE attention's (512, 512) weights, in a directory of their own."""
    out = tmp_path / "manifests"
    out.mkdir()
    for name in MANIFESTS:
        m = convert.load_manifest(name)
        keep = {k: s for k, s in m.items()
                if int(np.prod(s)) <= limit or ".attentions.0." in k and name == "vae_sd"}
        (out / f"{name}.json").write_text(json.dumps(keep))
    return str(out)


@pytest.fixture
def small_manifests(tmp_path, monkeypatch):
    path = _small_manifests(tmp_path)
    monkeypatch.setattr(convert, "MANIFEST_DIR", path)
    monkeypatch.setattr(jconvert, "MANIFEST_DIR", path)
    return path


@pytest.mark.parametrize("vae_era", ["legacy", "modern_4d"])
def test_validate_checkpoint_matches_jax(small_manifests, tmp_path, vae_era):
    key = "runwayml/stable-diffusion-v1-5"
    root = tmp_path / "fab"
    fabricate.fabricate_model(key, str(root))
    ckpt = root / key.replace("/", "--")
    clean = convert.validate_checkpoint(key, str(ckpt))
    assert clean == jconvert.validate_checkpoint(key, str(ckpt))
    assert all(r == {"missing": [], "extra": [], "shape": []} for r in clean.values())

    def rewrite(component, edit):
        path = str(ckpt / component / fabricate.FILENAMES[component])
        sd = dict(safetensors_io.read(path))
        edit(sd)
        safetensors_io.write(sd, path)

    def unet(sd):
        del sd["conv_out.bias"]
        sd["unexpected.weight"] = torch.zeros(1)
        sd["conv_in.bias"] = torch.zeros(7)

    def vae(sd):
        if vae_era == "modern_4d":
            for k in [k for k in sd if ".attentions.0." in k]:
                v = sd.pop(k)
                for new, old in LEGACY.items():
                    k = k.replace(f".attentions.0.{old}.", f".attentions.0.{new}.")
                sd[k] = v[:, :, None, None] if v.dim() == 2 else v
        sd["decoder.mid_block.attentions.0.group_norm.bias"] = torch.zeros(3)

    rewrite("unet", unet)
    rewrite("vae", vae)
    rewrite("text_encoder", lambda sd: sd.__setitem__(
        "text_model.embeddings.position_ids", torch.arange(77)[None]))
    got = convert.validate_checkpoint(key, str(ckpt))
    assert got == jconvert.validate_checkpoint(key, str(ckpt))
    assert got["unet"] == {"missing": ["conv_out.bias"], "extra": ["unexpected.weight"],
                           "shape": ["conv_in.bias"]}
    assert got["vae"] == {"missing": [], "extra": [],
                          "shape": ["decoder.mid_block.attentions.0.group_norm.bias"]}
    assert got["text_encoder"] == {"missing": [], "extra": [], "shape": []}


def test_validate_checkpoint_refuses_an_unknown_key(tmp_path):
    with pytest.raises(KeyError):
        convert.validate_checkpoint("tiny-test", str(tmp_path))
    with pytest.raises(KeyError):
        jconvert.validate_checkpoint("tiny-test", str(tmp_path))


# ---- (d) tokenizer refusal, its override, LMDX_CHECKPOINT_DIR --------------------

REAL_VOCAB_KEY = "test/tiny-real-vocab"


@pytest.fixture
def real_vocab(tmp_path, monkeypatch):
    """A tiny-test config with CLIP's real vocabulary size (49408 >= BOS_ID)
    under REAL_VOCAB_KEY in both packages, its checkpoint under
    tmp_path/root, and HOME without a tokenizer."""
    tcfg = dataclasses.replace(tconfig.tiny_test(), key=REAL_VOCAB_KEY, clip=dataclasses.replace(
        tconfig.tiny_test().clip, vocab_size=49408))
    jbase = jmodels.SD_CONFIGS["tiny-test"]()
    jcfg = dataclasses.replace(jbase, key=REAL_VOCAB_KEY, clip=dataclasses.replace(
        jbase.clip, vocab_size=49408))
    monkeypatch.setitem(tconfig.SD_CONFIGS, REAL_VOCAB_KEY, lambda: tcfg)
    monkeypatch.setitem(jconfig.SD_CONFIGS, REAL_VOCAB_KEY, lambda: jcfg)
    monkeypatch.setenv("HOME", str(tmp_path))
    for var in ("LMDX_TOKENIZER_DIR", "LMDX_CLIP_BPE", "LMDX_ALLOW_WORD_TOKENIZER",
                "LMDX_CHECKPOINT_DIR"):
        monkeypatch.delenv(var, raising=False)
    jtok.default_tokenizer.cache_clear()
    ttok.default_tokenizer.cache_clear()
    root = tmp_path / "root"
    write_checkpoint(root / REAL_VOCAB_KEY.replace("/", "--"), _state_dicts(tcfg))
    yield root / REAL_VOCAB_KEY.replace("/", "--")
    jtok.default_tokenizer.cache_clear()
    ttok.default_tokenizer.cache_clear()


def _both(ckpt, **kw):
    return (jmodels.load_bundle.__wrapped__(REAL_VOCAB_KEY, ckpt, **kw),
            tmodels.load_bundle(REAL_VOCAB_KEY, ckpt, device="cpu", **kw))


def test_real_vocab_checkpoint_without_tokenizer_is_refused(real_vocab, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()  # no weights: the refusal comes before any read
    for ckpt in (str(empty), str(real_vocab)):
        with pytest.raises(ValueError, match="WordTokenizer"):
            jmodels.load_bundle.__wrapped__(REAL_VOCAB_KEY, ckpt)
        with pytest.raises(ValueError, match="WordTokenizer"):
            tmodels.load_bundle(REAL_VOCAB_KEY, ckpt, device="cpu")


def test_allow_word_tokenizer_overrides_the_refusal(real_vocab, monkeypatch):
    monkeypatch.setenv("LMDX_ALLOW_WORD_TOKENIZER", "1")
    jb, tb = _both(str(real_vocab))
    assert type(tb.tokenizer).__name__ == type(jb.tokenizer).__name__ == "WordTokenizer"
    text = "a red cube and a blue ball"
    assert tb.tokenizer.encode(text, pad_to=77) == list(jb.tokenizer.encode(text, pad_to=77))
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jb.params), tb.config)
    _assert_state_dicts_equal(tb.text_encoder.state_dict(), want["text"])


def test_checkpoint_tokenizer_is_the_clip_bpe(real_vocab):
    tok = real_vocab / "tokenizer"
    tok.mkdir()
    (tok / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(VOCAB)}))
    (tok / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES))
    jb, tb = _both(str(real_vocab))
    assert type(tb.tokenizer).__name__ == type(jb.tokenizer).__name__ == "ClipBpeTokenizer"
    text = "cat dog big cat"
    assert tb.tokenizer.encode(text, pad_to=77) == list(jb.tokenizer.encode(text, pad_to=77))


def test_checkpoint_dir_is_discovered_like_jax(real_vocab, monkeypatch, tmp_path):
    monkeypatch.setenv("LMDX_ALLOW_WORD_TOKENIZER", "1")
    monkeypatch.setenv("LMDX_CHECKPOINT_DIR", str(real_vocab.parent))
    jb, tb = _both(None)
    assert tb.checkpoint_dir == jb.checkpoint_dir == str(real_vocab)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jb.params), tb.config)
    for part, got in _bundle_params(tb).items():
        _assert_state_dicts_equal(got, want[part])
    # A root without this model's directory: random weights on both sides
    # (the JAX side's random init, which compiles for ~25 s, is stubbed).
    monkeypatch.setenv("LMDX_CHECKPOINT_DIR", str(tmp_path / "nowhere"))
    assert tmodels.load_bundle(REAL_VOCAB_KEY, device="cpu").checkpoint_dir is None
    monkeypatch.setattr(jmodels, "init_random_params", lambda *a, **kw: {"random": True})
    jb = jmodels.load_bundle.__wrapped__(REAL_VOCAB_KEY)
    assert jb.checkpoint_dir is None and jb.params == {"random": True}


def test_sam_checkpoint_is_discovered_like_jax(tmp_path, monkeypatch):
    from lmdx.cli import generate as jgen

    monkeypatch.setenv("LMDX_CHECKPOINT_DIR", str(tmp_path))
    assert tmodels.discover_sam_checkpoint() is None is jgen.discover_sam_checkpoint()
    (tmp_path / "facebook--sam-vit-base").mkdir()
    assert tmodels.discover_sam_checkpoint() == jgen.discover_sam_checkpoint() == str(
        tmp_path / "facebook--sam-vit-base")
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR")
    assert tmodels.discover_sam_checkpoint() is None is jgen.discover_sam_checkpoint()


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_non_bf16_on_cuda_is_refused_at_load(dtype, tmp_path):
    """What the CUDA kernels do not take is refused before reading (tmp_path
    holds no weights): float16 (every attention kernel takes bf16 and
    float32). Float32 passes the dtype gate, alone and with the head-packed
    and fused-heads options (kernels 3 and 4 have float32 forms), and then
    meets the missing tokenizer."""
    kernels = tconfig.KernelOptions(packed_attention=True, fused_heads=True)
    if dtype == "float16":
        with pytest.raises(ValueError, match="bfloat16"):
            tmodels.load_bundle("runwayml/stable-diffusion-v1-5", str(tmp_path), dtype=dtype,
                                device="cuda")
        return
    for kw in ({"kernels": kernels}, {}):
        with pytest.raises(ValueError, match="tokenizer"):
            tmodels.load_bundle("runwayml/stable-diffusion-v1-5", str(tmp_path), dtype=dtype,
                                device="cuda", **kw)


# ---- (e) production shapes on the meta device -----------------------------------

def _to_legacy(key):
    for new, old in LEGACY.items():
        key = key.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
    return key


UNET_VALUES = {"gligen/diffusers-generation-text-box": 1_068_623_204,
               "runwayml/stable-diffusion-v1-5": 859_520_964,
               "stabilityai/stable-diffusion-2-1-base": 865_910_724,
               "stabilityai/stable-diffusion-xl-base-1.0": 2_567_463_684,
               "stabilityai/stable-diffusion-xl-refiner-1.0": 2_259_526_660}


@pytest.mark.parametrize("model_key", sorted(convert._COMPONENT_MANIFESTS))
def test_full_size_modules_match_the_manifests(model_key):
    cfg = tconfig.SD_CONFIGS[model_key]()
    with torch.device("meta"):
        parts = tmodels.build_modules(cfg)
    assert all(p.is_meta for m in parts.values() if m is not None for p in m.parameters())
    unet = {k: list(v.shape) for k, v in parts["unet"].state_dict().items()}
    if parts["position_net"] is not None:
        unet.update({f"position_net.{k}": list(v.shape)
                     for k, v in parts["position_net"].state_dict().items()})
    text = {k: list(v.shape) for k, v in parts["text"].state_dict().items()}
    vae = {k: list(v.shape) for k, v in parts["vae"].state_dict().items()}
    manifests = convert._COMPONENT_MANIFESTS[model_key]
    assert unet == convert.load_manifest(manifests["unet"])
    assert text == convert.load_manifest(manifests[cfg.text_encoder_dir])
    # The SDXL base's second tower (bigG) is text_encoder_2/.
    assert (parts["text2"] is not None) == ("text_encoder_2" in manifests
                                            and cfg.text_encoder_dir != "text_encoder_2")
    if parts["text2"] is not None:
        text2 = {k: list(v.shape) for k, v in parts["text2"].state_dict().items()}
        assert text2 == convert.load_manifest(manifests["text_encoder_2"])
    want_vae = convert.load_manifest(manifests["vae"])
    renamed = {k for k in vae if _to_legacy(k) != k}
    assert len(renamed) == 16
    assert {_to_legacy(k): s for k, s in vae.items()} == want_vae
    n = sum(int(np.prod(s)) for s in unet.values())
    assert n == UNET_VALUES[model_key]


def test_full_size_sam_matches_its_manifest_but_the_unused_keys():
    with torch.device("meta"):
        model = tsam.Sam(tsam.sam_vit_base(), torch.bfloat16)
    have = {k: list(v.shape) for k, v in model.state_dict().items()}
    want = convert.load_manifest(convert.SAM_MANIFEST)
    unused = sorted(set(want) - set(have))
    assert not set(have) - set(want)
    assert len(unused) == 11 and all(k.startswith(convert.SAM_UNUSED_PREFIXES) for k in unused)
    assert sum(k.startswith("prompt_encoder.mask_embed.") for k in unused) == 10
    assert all(want[k] == s for k, s in have.items())


@pytest.mark.parametrize("name", MANIFESTS)
def test_port_manifests_are_the_jax_manifests(name):
    assert filecmp.cmp(os.path.join(convert.MANIFEST_DIR, f"{name}.json"),
                       os.path.join(jconvert.MANIFEST_DIR, f"{name}.json"), shallow=False)


# ---- (f) the fabricator ---------------------------------------------------------

def _fabricate_in_subprocess(manifest_dir, root, hash_seed):
    code = ("import sys\n"
            "from lmdx_torch.runtime import convert, fabricate\n"
            f"convert.MANIFEST_DIR = {manifest_dir!r}\n"
            f"sys.exit(fabricate.main(['--root', {root!r}, '--sam', '--dtype', 'float16',"
            " '--models', *sorted(convert._COMPONENT_MANIFESTS)]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONHASHSEED=str(hash_seed))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*") if p.is_file())


def test_fabricator_writes_the_manifests_with_stable_bytes(tmp_path):
    manifests = _small_manifests(tmp_path, limit=20_000)
    a, b = tmp_path / "a", tmp_path / "b"
    _fabricate_in_subprocess(manifests, str(a), 1)
    _fabricate_in_subprocess(manifests, str(b), 2)
    files = _files(a)
    assert files == _files(b) and len(files) == 17
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f

    def manifest(name):
        return json.loads((Path(manifests) / f"{name}.json").read_text())

    expect = {"facebook--sam-vit-base/model.safetensors": convert.SAM_MANIFEST}
    for key, comps in convert._COMPONENT_MANIFESTS.items():
        for component, name in comps.items():
            expect[f"{key.replace('/', '--')}/{component}/"
                   f"{fabricate.FILENAMES[component]}"] = name
    assert sorted(map(str, files)) == sorted(expect)
    for f, name in expect.items():
        sd = safetensors_io.read(str(a / f))
        want = manifest(name)
        assert {k: list(v.shape) for k, v in sd.items()} == want, f
        for k, v in sd.items():
            assert v.dtype == torch.float16
            if fabricate._is_norm_weight(k, want[k]):
                assert torch.equal(v, torch.ones_like(v)), k
        noise = torch.cat([v.float().flatten() for k, v in sd.items()
                           if not fabricate._is_norm_weight(k, want[k])])
        assert abs(noise.std().item() - 0.02) < 2e-3 and abs(noise.mean().item()) < 1e-3


def test_fabricated_sam_loads_into_the_segmenter(tmp_path, monkeypatch):
    """The full-size SAM ViT-B (94M values, written in fp16), read back
    through the discovery of LMDX_CHECKPOINT_DIR: every parameter is the
    file's tensor cast to the parameter's dtype."""
    fabricate.fabricate_sam(str(tmp_path), torch.float16)
    monkeypatch.setenv("LMDX_CHECKPOINT_DIR", str(tmp_path))
    ckpt = tmodels.discover_sam_checkpoint()
    seg = tmodels.load_segmenter(ckpt, device="cpu")
    sd = convert.load_sam_state_dict(ckpt)
    params = dict(seg.model.named_parameters())
    assert sorted(params) == sorted(sd)
    for name, p in params.items():
        keep = any(m in name for m in tmodels.SAM_F32_MARKERS)
        assert p.dtype == (torch.float32 if keep else torch.bfloat16), name
        assert torch.equal(p, sd[name].to(p.dtype)), name


# ---- (g) SAM from a checkpoint directory against the JAX segmenter ------------------

def _mask_embed(cfg, rng):
    """The 11 SamModel tensors the port drops, at `cfg`'s widths."""
    c = cfg.out_dim
    shapes = {"conv1.weight": (4, 1, 2, 2), "conv1.bias": (4,),
              "conv2.weight": (16, 4, 2, 2), "conv2.bias": (16,),
              "conv3.weight": (c, 16, 1, 1), "conv3.bias": (c,),
              "layer_norm1.weight": (4,), "layer_norm1.bias": (4,),
              "layer_norm2.weight": (16,), "layer_norm2.bias": (16,)}
    out = {f"prompt_encoder.mask_embed.{k}": torch.tensor(rng.standard_normal(s),
                                                          dtype=torch.float32)
           for k, s in shapes.items()}
    out["shared_image_embedding.positional_embedding"] = torch.tensor(
        rng.standard_normal((2, c // 2)), dtype=torch.float32)
    return out


@pytest.mark.parametrize("prompt", ["input_boxes", "input_points"])
def test_sam_from_a_checkpoint_segments_like_jax(tmp_path, prompt):
    from tests.test_torch_sam import BOXES, POINTS

    cfg = tsam.tiny_sam()
    model = tmodels.build_sam(cfg, seed=0, device="cpu", dtype=torch.float32)
    tree = jsam.convert_sam({k: v.numpy() for k, v in model.state_dict().items()},
                            jsam.tiny_sam())
    sd = {**convert.sam_from_jax_params(tree), **_mask_embed(cfg, np.random.default_rng(5))}
    (tmp_path / "sam").mkdir()
    safetensors_io.write(sd, str(tmp_path / "sam" / "model.safetensors"))
    loaded = convert.load_sam_state_dict(str(tmp_path / "sam"))
    assert len(sd) - len(loaded) == 11
    seg = tsam.SamSegmenter(tmodels.build_sam(cfg, loaded, device="cpu", dtype=torch.float32))
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (32, 32, 3), np.uint8) for _ in range(5)]
    kw = {prompt: BOXES if prompt == "input_boxes" else POINTS}
    want = jsam.FlaxSamSegmenter(tree, jsam.tiny_sam(), dtype=jnp.float32).segment_batch(
        images, target_hw=(16, 16), **kw)
    got = seg.segment_batch(images, target_hw=(16, 16), **kw)
    assert len(got) == len(want) == 5
    for (gm, gi), (wm, wi) in zip(got, want):
        np.testing.assert_array_equal(gm, np.asarray(wm))
        np.testing.assert_allclose(gi, np.asarray(wi), atol=1e-5, rtol=0)
