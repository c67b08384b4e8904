"""The port's OWL-ViT stage-2 eval (`lmdx_torch.nn.owlvit`,
`lmdx_torch.eval.owl_vit`, `lmdx_torch.cli.owl_vit_eval`) held against the
JAX package, which runs here on the CPU as tests/test_owlvit.py runs it.

Both sides compute in float32 on the same weights: the JAX tiny model's
initial parameters, carried across by `convert.owlvit_from_jax_params`.
Tolerances: boxes 1e-5 and logits 1e-4 absolute (float32 sums in other
orders through two transformer towers; flax's LayerNorm takes the fast
variance E[x^2] - E[x]^2, torch's two passes); against transformers the JAX
side's own 5e-5 / 5e-4 (its LayerNorms take 1e-5 where the JAX modules take
flax's 1e-6). The device resize is held to PIL within 2 LSB on fewer than
1% of pixels (the protocol's bound) and to the JAX one within 1 LSB on fewer
than 1%: its float64 sums of the 22-bit weights are exact, the JAX side's
float32 sums at HIGHEST land a value that sits on a rounding boundary one
level off on ~0.1-0.2% of pixels (measured here: the port equals PIL on every
pixel of these inputs).
"""

import dataclasses
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lmdx.eval import owl_vit as jeval
from lmdx.nn import owlvit as jowl
from lmdx_torch.cli import owl_vit_eval as cli
from lmdx_torch.eval import owl_vit as peval
from lmdx_torch.nn import owlvit as powl
from lmdx_torch.runtime import convert, fabricate, models, safetensors_io

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    """(JAX detector, port detector on the CPU, port config) on one set of
    weights."""
    jcfg = jowl.tiny_owlvit()
    params = jowl.OwlViT(jcfg).init(
        jax.random.key(0), jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)),
        jnp.zeros((2, jcfg.text.max_length), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = powl.tiny_owlvit()
    mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert mine.pop("text").items() <= theirs.pop("text").items() and mine == theirs
    port = peval.OwlViTDetector(convert.owlvit_from_jax_params(params), cfg, device="cpu")
    return jeval.FlaxOwlViTDetector(params, jcfg), port, cfg


def _ids(cfg, shape, seed):
    """Token ids with an EOS (vocab - 1) mid-row and zeros after it."""
    rng = np.random.default_rng(seed)
    ids = np.zeros(shape + (cfg.text.max_length,), np.int64)
    flat = ids.reshape(-1, cfg.text.max_length)
    for row in flat:
        n = int(rng.integers(2, cfg.text.max_length - 1))
        row[:n] = rng.integers(1, cfg.text.vocab_size - 1, n)
        row[n] = cfg.text.vocab_size - 1
    return ids


@pytest.mark.parametrize("per_image_queries", [False, True], ids=["shared", "per_image"])
def test_owlvit_matches_jax(pair, per_image_queries):
    jdet, pdet, cfg = pair
    rng = np.random.default_rng(1)
    px = rng.standard_normal((2, cfg.image_size, cfg.image_size, 3), dtype=np.float32)
    ids = _ids(cfg, (2, 3) if per_image_queries else (3,), seed=2)
    jb, jl = jdet.model.apply({"params": jdet.params}, jnp.asarray(px),
                              jnp.asarray(ids.astype(np.int32)))
    with torch.no_grad():
        pb, pl = pdet.model(torch.from_numpy(px), torch.from_numpy(ids))
    assert pb.shape == (2, cfg.grid ** 2, 4) and pl.shape == (2, cfg.grid ** 2, 3)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_owlvit_matches_transformers():
    """OwlViTForObjectDetection (the stage-2 eval model) at a matched tiny
    config, its state dict loaded as it is (no conversion)."""
    from transformers import OwlViTConfig as TOwlCfg
    from transformers import OwlViTForObjectDetection

    cfg = dataclasses.replace(powl.tiny_owlvit(), projection_dim=32)
    tcfg = TOwlCfg(
        text_config=dict(vocab_size=cfg.text.vocab_size, hidden_size=cfg.text.hidden_size,
                         intermediate_size=cfg.text.intermediate_size,
                         num_hidden_layers=cfg.text.num_layers,
                         num_attention_heads=cfg.text.num_heads,
                         max_position_embeddings=cfg.text.max_length),
        vision_config=dict(hidden_size=cfg.vision_hidden, intermediate_size=cfg.vision_mlp,
                           num_hidden_layers=cfg.vision_layers,
                           num_attention_heads=cfg.vision_heads,
                           image_size=cfg.image_size, patch_size=cfg.patch_size),
        projection_dim=cfg.projection_dim)
    torch.manual_seed(0)
    tm = OwlViTForObjectDetection(tcfg).eval()
    sd = {k: v for k, v in tm.state_dict().items()
          if k not in convert.OWLVIT_UNUSED and "position_ids" not in k}
    model = models.build_owlvit(cfg, sd, device="cpu")

    rng = np.random.default_rng(1)
    px = rng.standard_normal((1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    L, eos = cfg.text.max_length, cfg.text.vocab_size - 1
    ids = np.zeros((2, L), np.int64)
    ids[0, :4] = (3, 17, 41, eos)
    ids[1, :6] = (3, 99, 12, 7, 120, eos)
    mask = (ids != 0).astype(np.int64)
    mask[:, 0] = 1
    with torch.no_grad():
        t_out = tm(input_ids=torch.from_numpy(ids),
                   pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2)),
                   attention_mask=torch.from_numpy(mask))
        boxes, logits = model(torch.from_numpy(px), torch.from_numpy(ids))
    np.testing.assert_allclose(boxes[0].numpy(), t_out.pred_boxes[0].numpy(), atol=5e-5)
    np.testing.assert_allclose(logits[0].numpy(), t_out.logits[0].numpy(), atol=5e-4)


@pytest.mark.parametrize("in_s,out_s", [(64, 96), (96, 64), (48, 48), (512, 768)])
def test_pil_bicubic_weights_equal_jax(in_s, out_s):
    assert np.array_equal(powl.pil_bicubic_weights(in_s, out_s),
                          jowl.pil_bicubic_weights(in_s, out_s))


@pytest.mark.parametrize("in_s,out_s", [(64, 96), (96, 64), (48, 48)])
def test_device_resize_matches_jax_and_pil(in_s, out_s):
    img = np.random.default_rng(in_s + out_s).integers(0, 256, (in_s, in_s, 3), np.uint8)
    w = powl.pil_bicubic_weights(in_s, out_s)
    port = powl.device_resize_bicubic(torch.from_numpy(img[None]), torch.from_numpy(w),
                                      torch.from_numpy(w))[0].numpy().astype(np.int32)
    jax_ = np.asarray(jowl.device_resize_bicubic(img[None], w, w))[0].astype(np.int32)
    pil = np.asarray(Image.fromarray(img).resize((out_s, out_s), Image.BICUBIC), np.int32)
    for other, lsb, share in ((jax_, 1, 1e-2), (pil, 2, 1e-2)):
        diff = np.abs(port - other)
        assert diff.max() <= lsb and (diff > 0).mean() < share, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("size", [64, 96], ids=["model_size", "device_resize"])
def test_detect_batch_matches_the_per_image_call(pair, size):
    """detect_batch (per-image query sets padded to a power of two, uint8
    upload, resize and normalization on the device) against __call__ (host
    PIL resize): equal math at the model's size, the resize's <= 2 LSB
    otherwise."""
    _, pdet, _ = pair
    rng = np.random.default_rng(size)
    images = [rng.integers(0, 255, (size, size, 3), np.uint8) for _ in range(3)]
    texts_list = [["a photo of a cat"], ["a photo of a dog", "a photo of a car"],
                  ["a cat", "a dog", "a bird"]]
    tol = 1e-5 if size == 64 else 5e-3
    batched = pdet.detect_batch(images, texts_list)
    for img, texts, (bb, bs, bl) in zip(images, texts_list, batched):
        rb, rs, rl = pdet(img, texts)
        assert bs.shape == rs.shape
        np.testing.assert_allclose(bb, rb, atol=tol)
        np.testing.assert_allclose(bs, rs, atol=tol)
        gap_ok = np.abs(np.sort(rs)[-1] - rs) > 1e-3 if size != 64 else slice(None)
        np.testing.assert_array_equal(bl[gap_ok], rl[gap_ok])


def test_detector_matches_jax_detector(pair):
    jdet, pdet, _ = pair
    rng = np.random.default_rng(4)
    image = rng.integers(0, 255, (64, 64, 3), np.uint8)
    texts = ["a photo of a cat", "a photo of a dog", "a photo of a car"]
    for got, want in zip(pdet(image, texts), jdet(image, texts)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


PLANTED = [
    ("A realistic photo of a scene with two cats",
     np.array([[0.1, 0.1, 0.3, 0.3], [0.6, 0.6, 0.9, 0.9]]), [0.9, 0.8], [0, 0]),
    ("A realistic photo of a scene with three cats",
     np.array([[0.1, 0.1, 0.3, 0.3], [0.6, 0.6, 0.9, 0.9]]), [0.9, 0.8], [0, 0]),
    ("A realistic photo of a scene with one cat",
     np.array([[0.1, 0.1, 0.5, 0.5], [0.11, 0.11, 0.5, 0.5]]), [0.9, 0.85], [0, 0]),
    ("A realistic photo of a scene with a blue dog and a white bowl",
     np.array([[0.1, 0.5, 0.4, 0.9], [0.5, 0.6, 0.8, 0.8], [0.1, 0.1, 0.2, 0.2]]),
     [0.7, 0.6, 0.1], [0, 1, 1]),
    ("A realistic photo of a scene with a bottle on the left and a dog on the right",
     np.array([[0.05, 0.3, 0.3, 0.7], [0.6, 0.3, 0.9, 0.7]]), [0.5, 0.4], [0, 1]),
]


@pytest.mark.parametrize("prompt,boxes,scores,labels", PLANTED)
@pytest.mark.parametrize("class_aware", [True, False])
def test_score_detections_with_planted_detections_equal_jax(prompt, boxes, scores, labels,
                                                             class_aware):
    from lmdx.eval.predicates import get_eval_info_from_prompt as jinfo

    from lmdx_torch.eval.predicates import get_eval_info_from_prompt as pinfo

    det = (boxes, np.asarray(scores), np.asarray(labels))
    (ptexts,), pinfo_ = pinfo(prompt)
    (jtexts,), jinfo_ = jinfo(prompt)
    got = peval._score_detections(prompt, ptexts, pinfo_, det, (512, 512),
                                  use_class_aware_nms=class_aware)
    want = jeval._score_detections(prompt, jtexts, jinfo_, det, (512, 512),
                                   use_class_aware_nms=class_aware)
    assert got == want


def _write_run(root: Path, inds=(0, 1, 3, 4), size=64, seed=2):
    rng = np.random.default_rng(seed)
    for ind in inds:
        d = root / str(ind)
        d.mkdir(parents=True)
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                        "RGB").save(d / "img_0.png")


def test_evaluate_run_matches_jax_batched_and_sequential(pair, tmp_path):
    """Prompt 2's image is missing and is skipped; the last chunk is padded."""
    jdet, pdet, _ = pair
    _write_run(tmp_path)
    kwargs = dict(prompt_type="lmd", model="gpt-4", num_prompts=5)
    reports = [fn(str(tmp_path), det, eval_batch=batch, **kwargs).summary()
               for fn, det in ((peval.evaluate_run, pdet), (jeval.evaluate_run, jdet))
               for batch in (1, 3)]
    assert len(set(reports)) == 1, reports
    assert "4" in reports[0].splitlines()[-1]  # 4 images scored


@pytest.fixture
def tiny_base(monkeypatch):
    """The CLI builds base-patch32; here it builds the tiny config."""
    monkeypatch.setattr(powl, "owlvit_base_patch32", powl.tiny_owlvit)


@pytest.mark.parametrize("weights", ["random", "checkpoint"])
def test_cli_main_on_the_tiny_detector(tiny_base, tmp_path, capsys, weights):
    run = tmp_path / "run"
    _write_run(run, inds=(0, 1, 2))
    argv = ["--run_base_path", str(run), "--prompt-type", "lmd_attribution",
            "--num_prompts", "3", "--eval-batch-size", "2", "--cpu"]
    if weights == "random":
        argv.append("--detector-random")
        detector = peval.OwlViTDetector(config=powl.tiny_owlvit(), device="cpu", seed=0)
    else:
        ckpt = tmp_path / "owlvit"
        ckpt.mkdir()
        model = models.build_owlvit(powl.tiny_owlvit(), seed=3, device="cpu")
        safetensors_io.write(dict(model.state_dict()), str(ckpt / "model.safetensors"))
        argv += ["--owlvit-checkpoint", str(ckpt)]
        detector = peval.OwlViTDetector.from_checkpoint(str(ckpt), device="cpu")
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out.strip()
    want = peval.evaluate_run(str(run), detector, prompt_type="lmd_attribution",
                              num_prompts=3, eval_batch=1).summary()
    assert printed == want
    assert "attribution" in printed and "/3" in printed.splitlines()[-1]


def test_cli_refuses_without_weights(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--run_base_path", str(tmp_path), "--cpu"])


def test_detector_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peval.OwlViTDetector(config=powl.tiny_owlvit())


def test_fabricated_owlvit_validates_and_loads_bit_for_bit(tmp_path):
    n = fabricate.fabricate_owlvit(str(tmp_path), torch.float16)
    assert n == 153_231_879
    path = tmp_path / "google--owlvit-base-patch32"
    report = convert.validate_component(convert.OWLVIT_MANIFEST, str(path))
    assert report == {"missing": [], "extra": [], "shape": []}
    sd = convert.load_owlvit_state_dict(str(path))
    assert not set(convert.OWLVIT_UNUSED) & set(sd)
    model = models.build_owlvit(state_dict=sd, device="cpu")
    loaded = model.state_dict()
    assert loaded.keys() == sd.keys()
    for k, v in sd.items():
        assert loaded[k].dtype == torch.float32 and torch.equal(loaded[k], v.float()), k
    assert torch.equal(model.box_bias, torch.from_numpy(powl.box_bias(24)))


def test_manifest_is_the_jax_packages():
    assert filecmp.cmp(REPO / "lmdx_torch/runtime/manifests/owlvit_base_patch32.json",
                       REPO / "lmdx/runtime/manifests/owlvit_base_patch32.json", shallow=False)


def test_owlvit_modules_import_no_jax():
    mods = ["lmdx_torch.nn.owlvit", "lmdx_torch.eval.owl_vit", "lmdx_torch.cli.owl_vit_eval"]
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'lmdx', 'safetensors', 'PIL'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
