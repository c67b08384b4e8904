"""The port's SAM (lmdx_torch/nn/sam.py) held against the JAX package's
(lmdx/nn/sam.py) on the CPU at the tiny config, in f32.

Weights: the port's seeded random init, exported to numpy and mapped onto
the Flax tree by the JAX package's own `convert_sam`. That proves the port's
transformers `SamModel` key names, and `sam_from_jax_params` must map the
tree back to the same state dict. (`Sam.init` is not used: it takes ~40 s
here.) Inputs are made with numpy from a seed.

Tolerances: embeddings, mask logits and IoU 1e-4 absolute (f32 sums in other
orders through a dozen layers); the segmenter's thresholded masks identical
and its IoU within 1e-5. The segmenter's input resize is an upscale (32 ->
64 here, 512 -> 1024 on the card), where `jax.image.resize` and torch's
bilinear interpolation compute the same function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn import sam as jsam
from lmdx_torch.nn import sam as tsam
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels

BOXES = [[(0.1, 0.1, 0.6, 0.7)], [(0.3, 0.2, 0.9, 0.8)], [(0.0, 0.4, 0.5, 1.0)],
         [(0.2, 0.0, 0.7, 0.5)], [(0.4, 0.4, 1.0, 1.0)]]
POINTS = [[(0.3, 0.4)], [(0.6, 0.5)], [(0.2, 0.8)], [(0.7, 0.2)], [(0.5, 0.5)]]


@pytest.fixture(scope="module")
def tiny():
    model = tmodels.build_sam(tsam.tiny_sam(), seed=0, device="cpu", dtype=torch.float32)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = jsam.convert_sam(sd, jsam.tiny_sam())
    return model, sd, tree


def test_state_dict_round_trips_through_convert_sam(tiny):
    model, sd, tree = tiny
    back = convert.sam_from_jax_params(tree)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # Every rel-pos table carries non-zero values (the JAX init is zeros).
    assert all(np.abs(v).min() > 0 for k, v in sd.items() if "rel_pos" in k)
    rebuilt = tmodels.build_sam(tsam.tiny_sam(), back, device="cpu", dtype=torch.float32)
    assert rebuilt.state_dict().keys() == model.state_dict().keys()


def test_key_names_are_transformers_sam_model_keys(tiny):
    """Every port parameter is a transformers SamModel parameter of the same
    shape (SamModel also has the mask-prompt encoder, which no path uses)."""
    transformers = pytest.importorskip("transformers")
    cfg = tsam.tiny_sam()
    ref = transformers.SamModel(transformers.SamConfig(
        vision_config=dict(
            hidden_size=cfg.encoder_dim, output_channels=cfg.out_dim,
            num_hidden_layers=cfg.encoder_layers, num_attention_heads=cfg.encoder_heads,
            image_size=cfg.image_size, patch_size=cfg.patch_size,
            window_size=cfg.window_size, global_attn_indexes=list(cfg.global_attn_layers),
            num_pos_feats=cfg.out_dim // 2),
        prompt_encoder_config=dict(hidden_size=cfg.out_dim, image_size=cfg.image_size,
                                   patch_size=cfg.patch_size),
        mask_decoder_config=dict(
            hidden_size=cfg.out_dim, num_hidden_layers=cfg.decoder_layers,
            num_attention_heads=cfg.decoder_heads, mlp_dim=cfg.out_dim * 8,
            num_multimask_outputs=cfg.num_multimask, iou_head_hidden_dim=cfg.out_dim),
    )).state_dict()
    for k, v in tiny[1].items():
        assert k in ref and tuple(ref[k].shape) == v.shape, k


def test_build_sam_dtype_policy():
    model = tmodels.build_sam(tsam.tiny_sam(), seed=1, device="cpu")
    for name, p in model.named_parameters():
        keep = any(m in name for m in tmodels.SAM_F32_MARKERS)
        assert p.dtype == (torch.float32 if keep else torch.bfloat16), name
    assert model.vision_encoder.layers[0].attn.rel_pos_h.dtype == torch.float32
    assert model.vision_encoder.layers[0].attn.qkv.weight.dtype == torch.bfloat16


def _pixels(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.image_size, cfg.image_size, 3), dtype=np.float32)


def test_image_encoder_matches_jax(tiny):
    model, _, tree = tiny
    px = _pixels(tsam.tiny_sam(), 2)
    want = jsam.SamImageEncoder(jsam.tiny_sam()).apply(
        {"params": tree["image_encoder"]}, jnp.asarray(px))
    with torch.no_grad():
        got = model.vision_encoder(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("labels", [[[2, 3], [2, 3]], [[1, -1], [0, -1]]],
                         ids=["box", "point"])
def test_sam_matches_jax(tiny, labels):
    model, _, tree = tiny
    px = _pixels(tsam.tiny_sam(), 2, seed=1)
    pts = np.random.default_rng(2).random((2, 2, 2)).astype(np.float32)
    lbl = np.asarray(labels, np.int32)
    want_m, want_iou = jsam.Sam(jsam.tiny_sam()).apply(
        {"params": tree}, jnp.asarray(px), jnp.asarray(pts), jnp.asarray(lbl))
    with torch.no_grad():
        got_m, got_iou = model(torch.from_numpy(px), torch.from_numpy(pts),
                               torch.from_numpy(lbl.astype(np.int64)))
    assert got_m.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou), atol=1e-4, rtol=0)


@pytest.mark.parametrize("prompt", ["input_boxes", "input_points"])
def test_segment_batch_matches_flax_segmenter(tiny, prompt):
    """Five images: more than one CHUNK, so the second chunk holds one."""
    model, _, tree = tiny
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (32, 32, 3), np.uint8) for _ in range(5)]
    kw = {prompt: BOXES if prompt == "input_boxes" else POINTS}
    want = jsam.FlaxSamSegmenter(tree, jsam.tiny_sam(), dtype=jnp.float32).segment_batch(
        images, target_hw=(16, 16), **kw)
    got = tsam.SamSegmenter(model).segment_batch(images, target_hw=(16, 16), **kw)
    assert len(got) == len(want) == 5
    for (gm, gi), (wm, wi) in zip(got, want):
        assert gm.dtype == np.bool_ and gm.shape == (3, 16, 16)
        np.testing.assert_array_equal(gm, np.asarray(wm))
        np.testing.assert_allclose(gi, np.asarray(wi), atol=1e-5, rtol=0)
    # The tensor input path gives the same masks as the numpy one.
    again = tsam.SamSegmenter(model).segment_batch(
        [torch.from_numpy(im) for im in images], target_hw=(16, 16), **kw)
    for (gm, _), (am, _) in zip(got, again):
        np.testing.assert_array_equal(gm, am)


def test_segmenter_rejects_mixed_sizes(tiny):
    """A batch of tensors (the pipelines' decoded images, on the model's
    device) of mixed sizes is refused, as the JAX segmenter refuses device
    arrays; host images of mixed sizes are resized by the JAX rule
    (tests/test_torch_entry_points.py)."""
    model, _, _ = tiny
    seg = tsam.SamSegmenter(model)
    images = [torch.zeros((32, 32, 3), dtype=torch.uint8),
              torch.zeros((16, 32, 3), dtype=torch.uint8)]
    with pytest.raises(ValueError):
        seg.segment_batch(images, input_boxes=BOXES[:2], target_hw=(16, 16))


@pytest.mark.parametrize("hw,win", [((6, 6), 4), ((8, 8), 4), ((5, 7), 3)])
def test_window_partition_matches_jax(hw, win):
    x = np.random.default_rng(4).standard_normal((2, *hw, 3), dtype=np.float32)
    jwin, jpad = jsam._window_partition(jnp.asarray(x), win)
    twin, tpad = tsam._window_partition(torch.from_numpy(x), win)
    assert tpad == jpad
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    back = tsam._window_unpartition(twin, win, tpad, hw)
    np.testing.assert_array_equal(back.numpy(), x)
