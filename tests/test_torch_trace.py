"""The port's tracing (`lmdx_torch/utils/trace.py`) and the spans and host
waits the program carries, on the CPU at the tiny-test size.

- `trace(dir)` yields `dir` and writes one Chrome trace there, holding the
  spans that `annotate(name)` and `wait(reason)` opened and the ops inside
  them; without a directory it writes under the temporary directory's
  `lmdx_trace`.
- With neither `recording()` nor `trace()` open, `annotate` and `wait`
  hand back one shared null context: no clock read, no `record_function`,
  nothing kept; a pipeline's images are bit-equal with recording on and off.
- Under `recording()` a grounded call gives one `request` root per call,
  every span inside its parent with the root's id, one `guidance_iter` per
  loss of the guidance loop and one `host_syncs["guidance_threshold"]` per
  read of its loop condition; a training step gives `train_step` over
  `cast_params`, `forward`, `backward`, `optimizer`, in that order.
"""

import inspect
import json
import os
import tempfile
import tracemalloc

import numpy as np
import pytest
import torch

from lmdx_torch import config as tconfig
from lmdx_torch import methods
from lmdx_torch.core.schedule import make_alphas_cumprod
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.nn import sam as tsam
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.sampling import guidance as tguidance
from lmdx_torch.training import train as ttrain
from lmdx_torch.utils import trace as ttrace

SPECS = [
    {"prompt": "A realistic scene with a red cube and a blue ball",
     "gen_boxes": [("a red cube", (50, 300, 120, 120)),
                   ("a blue ball", (300, 280, 100, 100))],
     "bg_prompt": "A realistic scene", "extra_neg_prompt": ""},
    {"prompt": "A park with a green tree",
     "gen_boxes": [("a green tree", (200, 100, 150, 250))],
     "bg_prompt": "A park", "extra_neg_prompt": "people"},
]
OVERRIDES = dict(max_iter=2, overall_max_iter=2, max_index_step=2,
                 overall_max_index_step=2, num_inference_steps=4)


def _events(log_dir):
    files = sorted(os.listdir(log_dir))
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(os.path.join(log_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


def _inside(events, name, outer, within=False):
    """The events named `name`, each inside the event `outer` (`within`:
    those of them that lie inside it, at least one)."""
    found = [e for e in events if e.get("name") == name]
    start, end = outer["ts"], outer["ts"] + outer["dur"]
    inside = [e for e in found if start <= e["ts"] and e["ts"] + e.get("dur", 0) <= end]
    assert inside and (within or inside == found), name
    return inside


@pytest.fixture(scope="module")
def tiny():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bundle = tmodels.build_bundle(tconfig.tiny_test(), seed=0, device="cpu")
    sam = tmodels.build_sam(tsam.tiny_sam(), seed=0, device="cpu", dtype=torch.float32)
    yield bundle, tsam.SamSegmenter(sam)
    torch.set_num_threads(threads)


def _run(kind, bundle, segmenter):
    if kind.startswith("batch_lmd_plus"):
        results = tbatch.run_lmd_plus_batch(SPECS, bundle, segmenter=segmenter,
                                            bg_seeds=[1, 2],
                                            defer_fetch=kind.endswith("deferred"), **OVERRIDES)
        # A deferred batch's images are fetched after its request has ended.
        methods.base.finalize_results(results)
        return results
    return [methods.get_method("lmd").run(SPECS[0], bundle, segmenter, bg_seed=1,
                                          **OVERRIDES)]


def _check_tree(spans):
    """Every span closed, inside its parent, with its root's request id."""
    for s in spans:
        assert s.end_ns >= s.start_ns >= 0
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
            assert s.request_id == p.request_id


@pytest.mark.parametrize("given", [True, False], ids=["dir", "default"])
def test_trace_writes_annotated_chrome_trace(tmp_path, monkeypatch, given):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    want_dir = str(tmp_path / "run") if given else str(tmp_path / "lmdx_trace")
    with ttrace.trace(want_dir if given else None) as log_dir:
        assert log_dir == want_dir
        with ttrace.annotate("train_step"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
            with ttrace.wait("loss_to_host"):
                value = float(x[0, 0])
    assert value == 64.0
    events = _events(log_dir)
    span = [e for e in events if e.get("name") == "train_step"]
    assert len(span) == 1 and span[0]["dur"] > 0
    _inside(events, "aten::mm", span[0])
    _inside(events, "wait:loss_to_host", span[0])


def test_off_reads_no_clock_enters_no_record_function_keeps_nothing(monkeypatch):
    def refuse(*_args, **_kw):
        raise AssertionError("touched while tracing is off")

    monkeypatch.setattr(ttrace, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    null = ttrace.annotate("warm")
    assert ttrace.wait("warm") is null
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with ttrace.annotate("request", request_id=3, boxes=2) as a, \
                    ttrace.wait("guidance_threshold") as w:
                assert a is None and w is None
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == ttrace.__file__ and d.size_diff > 0]
    assert not grown, grown
    assert ttrace.annotate("other", boxes=1) is null and ttrace.wait("other") is null


def test_recorder_numbers_roots_and_keeps_attrs():
    with ttrace.recording() as rec:
        with ttrace.annotate("request", boxes=3):
            with ttrace.annotate("per_box_pass"), ttrace.wait("latents_to_host"):
                pass
        with pytest.raises(ValueError):
            with ttrace.annotate("train_step", request_id=41), ttrace.annotate("forward"):
                raise ValueError
        with ttrace.annotate("request"), ttrace.annotate("train_step", request_id=7):
            pass
    assert ttrace.annotate("after") is ttrace.annotate("after")
    assert [(s.name, s.parent, s.request_id) for s in rec.spans] == [
        ("request", None, 0), ("per_box_pass", 0, 0), ("wait:latents_to_host", 1, 0),
        ("train_step", None, 41), ("forward", 3, 41), ("request", None, 42),
        ("train_step", 5, 42)]
    assert rec.spans[0].attrs == {"boxes": 3}
    assert dict(rec.counts["host_syncs"]) == {"latents_to_host": 1}
    _check_tree(rec.spans)


def test_wait_adds_no_synchronisation(monkeypatch):
    def refuse(*_args, **_kw):
        raise AssertionError("wait synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    x = torch.arange(4.0)
    with ttrace.recording() as rec:
        with ttrace.wait("sam_masks_to_host"):
            host = x.numpy()
    assert host.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert rec.counts["host_syncs"]["sam_masks_to_host"] == 1
    assert [s.name for s in rec.spans] == ["wait:sam_masks_to_host"]


def test_recording_off_reads_no_clock_and_images_are_bit_equal(tiny, monkeypatch):
    bundle, segmenter = tiny
    with ttrace.recording() as rec:
        on = _run("batch_lmd_plus", bundle, segmenter)
    assert rec.spans

    def refuse():
        raise AssertionError("the trace clock was read with recording off")

    monkeypatch.setattr(ttrace, "_clock", refuse)
    off = _run("batch_lmd_plus", bundle, segmenter)
    for a, b in zip(on, off, strict=True):
        np.testing.assert_array_equal(a.image, b.image)
        for ma, mb in zip(a.aux["masks"], b.aux["masks"], strict=True):
            np.testing.assert_array_equal(ma, mb)


@pytest.mark.parametrize("kind", ["batch_lmd_plus", "batch_lmd_plus_deferred",
                                  "grounded_lmd"])
def test_request_spans_nest_and_count_the_guidance_loop(tiny, monkeypatch, kind):
    bundle, segmenter = tiny
    losses, reads = [0], [0]
    loss_fn, update_fn = tguidance.ca_loss_batched, tguidance.guidance_update_batched

    def ca_loss_batched(*args, **kwargs):
        losses[0] += 1
        return loss_fn(*args, **kwargs)

    def guidance_update_batched(*args, **kwargs):
        before = losses[0]
        out = update_fn(*args, **kwargs)
        # The loop condition is read before each iteration, and once more
        # when the loss, not the budget, ends the loop.
        iters = losses[0] - before
        budget = inspect.signature(update_fn).bind(*args, **kwargs).arguments["max_iter"]
        reads[0] += iters + (iters < budget)
        return out

    monkeypatch.setattr(tguidance, "ca_loss_batched", ca_loss_batched)
    monkeypatch.setattr(tguidance, "guidance_update_batched", guidance_update_batched)
    with ttrace.recording() as rec:
        for _ in range(2):
            _run(kind, bundle, segmenter)
    spans = rec.spans
    _check_tree(spans)
    roots = [s for s in spans if s.parent is None]
    batched = kind.startswith("batch_lmd_plus")
    if kind.endswith("deferred"):
        # Each batch's fetch is a root of its own, under its request's id.
        assert [(s.name, s.request_id) for s in roots] == [
            ("request", 0), ("wait:images_to_host", 0),
            ("request", 1), ("wait:images_to_host", 1)]
        roots = roots[::2]
    assert [(s.name, s.request_id) for s in roots] == [("request", 0), ("request", 1)]
    boxes = 3 if batched else 2
    assert roots[0].attrs == {"layouts": 2 if batched else 1, "boxes": boxes}
    names = [s.name for s in spans]
    for name in ("text", "per_box_pass", "overall_pass", "guidance", "decode", "segment",
                 "sam_pixels", "sam_chunk", "wait:sam_masks_to_host", "compose",
                 "wait:images_to_host"):
        assert names.count(name) >= 2, name
    if kind == "grounded_lmd":
        # One wait a copy: the trajectory and each saved tap map, per call.
        unet_cfg = bundle.config.unet
        taps = len(dict.fromkeys((tguidance.default_obj_attn_key(unet_cfg),
                                  *tguidance.default_guidance_keys(unet_cfg))))
        assert names.count("wait:latents_to_host") == 2
        assert names.count("wait:taps_to_host") == 2 * taps
    else:
        assert "gligen" in names and "wait:pooled_to_host" in names
    assert names.count("guidance_iter") == losses[0] > 0
    assert rec.counts["host_syncs"]["guidance_threshold"] == reads[0] >= losses[0]
    assert names.count("wait:guidance_threshold") == reads[0]
    waits = sum(rec.counts["host_syncs"].values())
    assert waits == sum(n.startswith("wait:") for n in names)
    for s in spans:
        if s.name in ("guidance_iter", "wait:guidance_threshold"):
            assert spans[s.parent].name == "guidance"
        if s.name in ("sam_pixels", "sam_chunk", "wait:sam_masks_to_host"):
            assert spans[s.parent].name == "segment"


def test_train_step_spans_in_order(tmp_path):
    torch.manual_seed(0)
    cfg = tconfig.SD_CONFIGS["tiny-test"]()
    unet = tmodels.build_train_unet(cfg, seed=0, device="cpu")
    opt = ttrain.make_optimizer(1e-4, trainable_mask=ttrain.gligen_adapter_mask(unet))
    step = ttrain.make_train_step(unet, opt, make_alphas_cumprod(),
                                  objs_fn=lambda _, b: b["objs"])
    state = ttrain.init_train_state(unet, opt)
    d = cfg.unet.cross_attention_dim
    batch = {"x0": torch.randn(2, 8, 8, 4), "noise": torch.randn(2, 8, 8, 4),
             "t": torch.tensor([10, 700]), "text_embeddings": torch.randn(2, 77, d),
             "objs": torch.randn(2, cfg.unet.gligen_max_objs, d)}
    with ttrace.trace(str(tmp_path)), ttrace.recording() as rec:
        for _ in range(2):
            state, _loss = step(state, batch)
    spans = rec.spans
    _check_tree(spans)
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [(spans[i].name, spans[i].request_id) for i in roots] == [
        ("train_step", 0), ("train_step", 1)]
    for i in roots:
        children = [s for s in spans if s.parent == i]
        assert [s.name for s in children] == ["cast_params", "forward", "backward",
                                              "optimizer"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(children, children[1:]))
    events = _events(str(tmp_path))
    chrome_steps = [e for e in events if e.get("name") == "train_step"]
    assert len(chrome_steps) == 2
    for step_event in chrome_steps:
        for name in ("cast_params", "forward", "backward", "optimizer"):
            assert len(_inside(events, name, step_event, within=True)) == 1, name



def test_each_unet_call_waits_once_for_its_timestep_upload(tiny, monkeypatch):
    bundle, segmenter = tiny
    calls = [0]
    forward = type(bundle.unet).forward

    def counted(self, *args, **kwargs):
        calls[0] += 1
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(type(bundle.unet), "forward", counted)
    with ttrace.recording() as rec:
        _run("batch_lmd_plus", bundle, segmenter)
    assert calls[0] > 0
    assert rec.counts["host_syncs"]["timesteps_to_device"] == calls[0]
    waits = [s for s in rec.spans if s.name == "wait:timesteps_to_device"]
    assert len(waits) == calls[0]
    assert {rec.spans[s.parent].name for s in waits} >= {"per_box_pass", "guidance_iter"}


def test_copies_wait_once_each_and_not_for_a_tensor_on_a_card():
    host = np.arange(6, dtype=np.float32).reshape(2, 3)
    on_card = torch.empty(2, 3, device="meta")      # no host copy to wait for
    with ttrace.recording() as rec:
        with ttrace.annotate("request"):
            up = ttrace.to_device(host, "cpu", "latents_to_device")
            same = ttrace.to_device(on_card, "meta", "latents_to_device")
            assert ttrace.request_id() == 0
            back = ttrace.to_host(up, "latents_to_host")
        late = ttrace.to_host(up, "images_to_host", request_id=0)
    np.testing.assert_array_equal(back, host)
    np.testing.assert_array_equal(late, host)
    assert same is on_card
    assert dict(rec.counts["host_syncs"]) == {"latents_to_device": 1, "latents_to_host": 1,
                                              "images_to_host": 1}
    assert [(s.name, s.parent, s.request_id) for s in rec.spans] == [
        ("request", None, 0), ("wait:latents_to_device", 0, 0),
        ("wait:latents_to_host", 0, 0), ("wait:images_to_host", None, 0)]
    assert ttrace.request_id() is None
