"""The port's stage-1 host side (`lmdx_torch/text/{cache,llm_client}.py`,
`eval/{prompts,predicates,stage_one}.py`, `utils/vis.py`,
`cli/{prompt_batch,eval_stage_one}.py`) held against the JAX package's on
the same inputs, on the CPU. These modules are copies; the tests show that
each gives the JAX package's result: equal prompt lists, predicate outcomes
on seeded random boxes, cache files either side reads, the same HTTP
requests to a scripted transport or a local fake server, equal reports and
images equal pixel for pixel. Nothing here reads the network or a checkout
of the reference.
"""

import json
import sys
import threading
import types
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from lmdx.cli import eval_stage_one as jeval_cli
from lmdx.cli import prompt_batch as jbatch_cli
from lmdx.eval import predicates as jpred
from lmdx.eval import prompts as jprompts
from lmdx.eval import stage_one as jstage
from lmdx.text import cache as jcache
from lmdx.text import llm_client as jllm
from lmdx.utils import vis as jvis
from lmdx_torch.cli import eval_stage_one as teval_cli
from lmdx_torch.cli import prompt_batch as tbatch_cli
from lmdx_torch.eval import predicates as tpred
from lmdx_torch.eval import prompts as tprompts
from lmdx_torch.eval import stage_one as tstage
from lmdx_torch.text import cache as tcache
from lmdx_torch.text import llm_client as tllm
from lmdx_torch.utils import vis as tvis
from tests.test_llm_client import VALID_RESPONSE, _FakeOpenAI

MODELS = ["gpt-4", "gpt-3.5", "vicuna"]


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """`query_layout` imports `requests` when no transport is injected; here
    that import finds a module whose `post` reaches only this host's fake
    server and fails the test for any other address."""
    import requests

    def post(url, **kwargs):
        if not url.startswith("http://127.0.0.1:"):
            raise AssertionError(f"a test reached for the network: {url}")
        return requests.post(url, **kwargs)

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(post=post))


# ---- prompts and predicates ---------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("prompt_type", jprompts.PROMPT_TYPES)
def test_get_prompts_matches_jax(prompt_type, model):
    want = jprompts.get_prompts(prompt_type, model=model)
    assert tprompts.get_prompts(prompt_type, model=model) == want
    assert tprompts.PROMPT_TYPES == jprompts.PROMPT_TYPES
    if prompt_type.startswith("lmd"):
        assert len(want) == (400 if prompt_type == "lmd" else 100)


def test_unknown_prompt_type_is_refused_like_jax():
    with pytest.raises(KeyError):
        jprompts.get_prompts("nope")
    with pytest.raises(KeyError):
        tprompts.get_prompts("nope")
    assert tprompts.get_prompts("nope", allow_non_exist=True) == []


def _names(prompt):
    """Box names around the prompt's own objects: its query phrases, a
    distractor, and one near miss that shares a suffix."""
    texts, _ = jpred.get_eval_info_from_prompt(prompt)
    names = [t.removeprefix("a photo of ") for t in texts[0]]
    return names + ["a tree", f"big {names[0]}", names[0] + "s"]


def _random_boxes(rng, names, n_max=6):
    return [{"name": str(rng.choice(names)),
             "bounding_box": [int(v) for v in rng.integers(0, 400, 2)]
                             + [int(v) for v in rng.integers(10, 200, 2)]}
            for _ in range(int(rng.integers(0, n_max + 1)))]


@pytest.mark.parametrize("split", ["lmd_negation", "lmd_numeracy", "lmd_attribution",
                                   "lmd_spatial"])
def test_predicates_match_jax_on_random_boxes(split):
    rng = np.random.default_rng(sum(map(ord, split)))
    jpairs = jprompts.get_lmd_prompt_predicates(split)
    tpairs = tprompts.get_lmd_prompt_predicates(split)
    assert [p for p, _ in tpairs] == [p for p, _ in jpairs]
    outcomes = []
    for (prompt, jp), (_, tp) in list(zip(jpairs, tpairs))[::4]:
        jtexts, jinfo = jpred.get_eval_info_from_prompt(prompt)
        ttexts, tinfo = tpred.get_eval_info_from_prompt(prompt)
        assert ttexts == jtexts
        assert {k: v for k, v in tinfo.items() if k != "predicate"} == \
            {k: v for k, v in jinfo.items() if k != "predicate"}
        for _ in range(12):
            boxes = _random_boxes(rng, _names(prompt))
            got = (tp(boxes), tinfo["predicate"](boxes))
            assert got == (jp(boxes), jinfo["predicate"](boxes)), (prompt, boxes)
            outcomes.append(got[0])
    assert any(outcomes) and not all(outcomes)


def test_numeracy_2obj_predicate_matches_jax():
    prompt = "A realistic photo of a scene with two dogs and three cats"
    rng = np.random.default_rng(7)
    _, jinfo = jpred.get_eval_info_from_prompt(prompt)
    _, tinfo = tpred.get_eval_info_from_prompt(prompt)
    assert tinfo["type"] == jinfo["type"] == "numeracy_2obj"
    for _ in range(50):
        boxes = _random_boxes(rng, ["a dog", "a cat", "a hotdog"], n_max=7)
        assert tinfo["predicate"](boxes) == jinfo["predicate"](boxes)


def test_detection_postprocess_matches_jax():
    rng = np.random.default_rng(11)
    xy = rng.random((40, 2)) * 0.7
    boxes = np.concatenate([xy, xy + rng.random((40, 2)) * 0.3], axis=1)
    scores, labels = rng.random(40), rng.integers(0, 3, 40)
    for threshold in (0.1, 0.3, 0.5):
        assert tpred.nms(boxes, scores, threshold) == jpred.nms(boxes, scores, threshold)
        for g, w in zip(tpred.class_aware_nms(boxes, scores, labels, threshold),
                        jpred.class_aware_nms(boxes, scores, labels, threshold)):
            np.testing.assert_array_equal(g, w)
    assert tpred.to_gen_box_format(boxes[0], 512, 384) == \
        jpred.to_gen_box_format(boxes[0], 512, 384)


# ---- the layout cache ------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_layout_cache_files_are_read_by_the_other_side(tmp_path, writer):
    w_mod, r_mod = (tcache, jcache) if writer == "port" else (jcache, tcache)
    path = str(tmp_path / "sub" / "cache.json")
    cache = w_mod.LayoutCache(path)
    for prompt, resp in [("p1", "r1"), ("p2", "r2"), ("p1", "r1b")]:
        cache.add(prompt, resp)
    assert cache.values_accessed() == 3
    other = r_mod.LayoutCache(path, allow_nonexist=False)
    assert len(other) == 2 and "p1" in other and "p3" not in other
    assert [other.get("p1"), other.get("p1"), other.get("p1")] == ["r1", "r1b", None]
    other.add("p3", "r3")
    back = w_mod.LayoutCache(path)
    assert back.get("p3") == "r3" and back.get("p2") == "r2"
    # Both sides write the same bytes for the same history.
    twin = str(tmp_path / "twin.json")
    again = r_mod.LayoutCache(twin)
    for prompt, resp in [("p1", "r1"), ("p2", "r2"), ("p1", "r1b"), ("p3", "r3")]:
        again.add(prompt, resp)
    assert open(twin).read() == open(path).read()


def test_missing_cache_is_refused_like_jax(tmp_path):
    for mod in (jcache, tcache):
        with pytest.raises(FileNotFoundError):
            mod.LayoutCache(str(tmp_path / "none.json"), allow_nonexist=False)


@pytest.mark.parametrize("args", [("lmd_spatial", "v0.1", "gpt-4", "cache"),
                                  ("demo", "v0.1", "gpt-3.5-turbo", "/x/y")])
def test_cache_filename_matches_jax(args):
    assert tcache.cache_filename(*args) == jcache.cache_filename(*args)


# ---- the LLM client, with one injected transport ----------------------------------

class _Response:
    def __init__(self, status, text, chat):
        self.status_code = status
        self._payload = ({"choices": [{"message": {"content": text}}]} if chat
                         else {"choices": [{"text": text}]})

    def json(self):
        return self._payload


def _scripted_post(script, calls):
    def post(url, json=None, headers=None):
        calls.append((url, json, dict(headers or {})))
        status, text = script.pop(0) if script else (200, VALID_RESPONSE)
        return _Response(status, text, "chat" in url)
    return post


SCRIPT = [(500, ""), (200, "no layout here"), (200, VALID_RESPONSE)]


@pytest.mark.parametrize("model", MODELS)
def test_query_and_parse_match_jax(model, monkeypatch):
    results = []
    for llm in (jllm, tllm):
        monkeypatch.setattr(llm.time, "sleep", lambda s: None)
        config = llm.get_llm_config(model, api_key="sk-test")
        calls = []
        layout = llm.get_parsed_layout("a red cube on a table", config,
                                       _post=_scripted_post(list(SCRIPT), calls))
        raw = llm.query_layout("a red cube on a table", config,
                               _post=_scripted_post([], calls))
        results.append((calls, layout.gen_boxes, layout.bg_prompt, layout.neg_prompt, raw,
                        config.api_base, config.model, config.is_chat_model))
    assert results[0] == results[1]
    assert len(results[1][0]) == 4  # 500, unparseable, valid; then one query
    with pytest.raises(RuntimeError):
        tllm.get_parsed_layout("x", tllm.get_llm_config(model),
                               _post=_scripted_post([(200, "bad")] * 3, []))


def test_query_layout_gives_up_like_jax(monkeypatch):
    for llm in (jllm, tllm):
        monkeypatch.setattr(llm.time, "sleep", lambda s: None)
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            llm.query_layout("x", llm.get_llm_config("gpt-4"), max_attempts=2,
                             _post=_scripted_post([(503, "")] * 2, []))


# ---- stage-1 evaluation -----------------------------------------------------------

def _layout_text(rng, prompt):
    boxes = _random_boxes(rng, _names(prompt), n_max=5)
    objs = ", ".join(f"('{b['name']}', {b['bounding_box']})" for b in boxes)
    return f"[{objs}]\nBackground prompt: A realistic scene\nNegative prompt: "


@pytest.fixture(scope="module")
def layout_cache(tmp_path_factory):
    """A cache of one random layout for each of the 400 benchmark prompts
    (the fake client: a prompt that repeats reads its next response), some
    of them satisfying their predicate."""
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("cache") / "cache_lmd_v0.1_gpt-4.json"
    data = {}
    for prompt in jprompts.get_prompts("lmd"):
        prompt = prompt.strip().rstrip(".")
        data.setdefault(prompt, []).append(_layout_text(rng, prompt))
    path.write_text(json.dumps(data, indent=4))
    return str(path)


@pytest.mark.parametrize("window", [(0, None), (150, 120)], ids=["all", "window"])
def test_evaluate_stage_one_matches_jax(layout_cache, window):
    skip, num = window
    reports = [
        stage.evaluate_stage_one("lmd", llm.get_llm_config("gpt-4"),
                                 cache.LayoutCache(layout_cache, allow_nonexist=False),
                                 skip_first_prompts=skip, num_prompts=num)
        for stage, llm, cache in ((jstage, jllm, jcache), (tstage, tllm, tcache))]
    want, got = reports
    assert got.success_counts == want.success_counts
    assert got.total_counts == want.total_counts
    assert got.summary() == want.summary()
    assert sum(got.total_counts.values()) == (400 if num is None else num)
    assert 0 < got.overall_rate < 1


def test_eval_layout_matches_jax():
    prompt = "A realistic photo of a scene with a dog on the left and a cat on the right"
    boxes = [{"name": "a dog", "bounding_box": [10, 200, 100, 100]},
             {"name": "a cat", "bounding_box": [300, 200, 100, 100]}]
    assert tstage.eval_layout(prompt, boxes) == jstage.eval_layout(prompt, boxes) == \
        ("spatial", True)


# ---- visualization ----------------------------------------------------------------

def _pixels(image):
    return np.asarray(image.convert("RGB"))


def test_vis_images_match_jax_pixel_for_pixel(tmp_path):
    rng = np.random.default_rng(4)
    boxes = [("a red car", (70, 278, 170, 180)), ("a blue bus", (284, 300, 150, 150))]
    masks = [rng.random((32, 32)) > 0.5 for _ in range(3)]
    arrays = [rng.standard_normal((8, 8)) for _ in range(3)]
    taps = rng.random((4, 2, 64))
    latents = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    traj = rng.standard_normal((11, 1, 8, 8, 4)).astype(np.float32)
    image = rng.integers(0, 255, (64, 64, 3), np.uint8)
    for make in (
        lambda v: v.draw_boxes(boxes, bg_prompt="A street", neg_prompt="people"),
        lambda v: v.draw_boxes([{"name": n, "bounding_box": list(b)} for n, b in boxes],
                               size=256),
        lambda v: v.annotate_image(image, [(0.1, 0.2, 0.5, 0.6), (0.4, 0.4, 0.9, 1.0)],
                                   names=["a", "b"]),
        lambda v: v.mask_grid(masks, cell=32),
        lambda v: v.mask_overlay(masks, size=64, seed=3),
        lambda v: v.heatmap(arrays[0], size=40),
        lambda v: v.array_grid(arrays, titles=["x", "y", "z"], cell=32),
        lambda v: v.attn_heatmaps(taps, cell=32),
        lambda v: v.masked_latents(latents, masks[0][:16, :16], cell=32),
        lambda v: v.latent_trajectory_strip(traj, stride=5, cell=24),
    ):
        np.testing.assert_array_equal(_pixels(make(tvis)), _pixels(make(jvis)))
    paths = []
    for v, sub in ((jvis, "j"), (tvis, "t")):
        saver = v.RunSaver(str(tmp_path / sub))
        paths.append([saver.save(image), saver.save(image, name="mask"),
                      saver.save(image, index=7), saver.save(image, indexed=False)])
    assert [p.rsplit("/", 1)[1] for p in paths[0]] == [p.rsplit("/", 1)[1] for p in paths[1]]


# ---- the CLIs against a local fake server ------------------------------------------

@pytest.fixture()
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeOpenAI)
    srv.script = []
    srv.requests = []
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_prompt_batch_cli_matches_jax(server, tmp_path, monkeypatch, capsys):
    outputs = []
    for name, cli in (("jax", jbatch_cli), ("port", tbatch_cli)):
        monkeypatch.setattr(cli.time, "sleep", lambda s: None)
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)  # layout renderings go under the working directory
        server.script = [(200, "nonsense")] + [(200, VALID_RESPONSE)] * 3
        before = len(server.requests)
        argv = ["--prompt-type", "demo", "--model", "gpt-4", "--auto-query",
                "--cache-dir", str(work), "--cpu",
                "--api-base", f"http://127.0.0.1:{server.server_address[1]}/v1"]
        assert cli.main(argv) == 0
        assert cli.main(argv + ["--visualize-cache-hit"]) == 0  # all cached now
        vis_dir = work / "img_generations" / "imgs_demo_templatev0.1"
        outputs.append((server.requests[before:],
                        (work / "cache_demo_v0.1_gpt-4.json").read_text(),
                        {p.name: _pixels(__import__("PIL.Image").Image.open(p))
                         for p in sorted(vis_dir.iterdir())},
                        capsys.readouterr().out))
    (jreq, jcache_text, jpng, jout), (treq, tcache_text, tpng, tout) = outputs
    assert treq == jreq and len(treq) == 4
    assert tcache_text == jcache_text
    assert sorted(tpng) == sorted(jpng) == ["boxes_0.png", "boxes_1.png", "boxes_2.png"]
    for k in jpng:
        np.testing.assert_array_equal(tpng[k], jpng[k])
    assert tout == jout


def test_prompt_batch_show_template_matches_jax(capsys):
    outs = []
    for cli in (jbatch_cli, tbatch_cli):
        assert cli.main(["--show-template", "--prompt-type", "demo"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "<your caption here>" in outs[1]


@pytest.mark.parametrize("extra", [[], ["--skip_first_prompts", "90", "--num_prompts", "30",
                                        "--verbose"]], ids=["all", "window"])
def test_eval_stage_one_cli_matches_jax(layout_cache, capsys, extra):
    outs = []
    for cli in (jeval_cli, teval_cli):
        assert cli.main(["--cache", layout_cache, "--model", "gpt-4", *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Overall" in outs[1]
