"""The port's WebUI (`lmdx_torch/webui/server.py`) through real HTTP requests
against a ThreadingHTTPServer on an ephemeral port, on the CPU at tiny-test,
and held against the JAX package's (`lmdx/webui/server.py`).

- The index page offers the JAX registry's methods; a bad form field and an
  unknown method come back as the page's error block, not a 500.
- A POST renders the cached layout and the method's image: the page's image
  is bit for bit what `get_method(m).run` gives on the same spec and seed.
- `App.layout` equals the JAX `App.layout` on the same cache.

The layout cache is written into `tmp_path` (the demo prompts, hand-written
responses in the template's format); a cache miss would query an LLM, so the
port's `query_layout` raises here.
"""

import argparse
import base64
import io
import json
import threading
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from lmdx import methods as jmethods
from lmdx.text import llm_client as jllm_client
from lmdx.webui import server as jserver
from lmdx_torch import methods as tmethods
from lmdx_torch.eval.prompts import PROMPTS_DEMO
from lmdx_torch.text import llm_client
from lmdx_torch.webui import server as tserver
from tests._torch_tiny import one_torch_thread
from tests.test_torch_generate import RESPONSES

# The webui looks a prompt up as it is typed; these are typed without the
# final period.
PROMPTS = [p.strip().rstrip(".") for p in PROMPTS_DEMO]


@pytest.fixture
def cache_path(tmp_path):
    path = tmp_path / "cache_demo_v0.1_gpt-4.json"
    path.write_text(json.dumps({p: [r] for p, r in zip(PROMPTS, RESPONSES)}))
    return str(path)


def _args(cache_path):
    return argparse.Namespace(host="127.0.0.1", port=0, sd_model="tiny-test",
                              llm_model="gpt-4", cache_path=cache_path, steps=50, cpu=True)


def _no_llm(*a, **k):
    raise AssertionError("the layout cache missed: no LLM query in a test")


@pytest.fixture
def webui(cache_path, monkeypatch):
    monkeypatch.setattr(llm_client, "query_layout", _no_llm)
    monkeypatch.setattr(tserver.Handler, "app", tserver.App(_args(cache_path)))
    server = ThreadingHTTPServer(("127.0.0.1", 0), tserver.Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", tserver.Handler.app
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, form):
    data = urllib.parse.urlencode(form).encode()
    with urllib.request.urlopen(url + "/generate", data=data, timeout=300) as r:
        return r.status, r.read().decode()


def _page_image(body: str, heading: str = "Image") -> np.ndarray:
    marker = f"<h3>{heading}</h3><img src=\"data:image/png;base64,"
    start = body.index(marker) + len(marker)
    data = base64.b64decode(body[start:body.index('"', start)])
    return np.asarray(Image.open(io.BytesIO(data)))


def test_index_page_lists_methods(webui):
    url, _ = webui
    with urllib.request.urlopen(url + "/", timeout=30) as r:
        assert r.status == 200
        body = r.read().decode()
    assert "<form" in body and 'action="/generate"' in body
    assert set(tmethods.METHODS) == set(jmethods.METHODS)
    for name in tmethods.METHODS:
        assert f'value="{name}"' in body
    assert '<option value="lmd_plus" selected>' in body
    assert 'name="steps" value="50"' in body


@pytest.mark.parametrize("form,needle", [
    ({"method": "sd", "seed": "abc", "steps": "2"}, "invalid literal"),
    ({"method": "no-such-method", "seed": "1", "steps": "2"}, "unknown method"),
])
def test_post_error_is_surfaced_in_page(webui, form, needle):
    url, app = webui
    status, body = _post(url, {"prompt": PROMPTS[0], **form})
    assert status == 200
    assert "Error:" in body and needle in body
    assert app._bundle is None  # nothing was built for a request that failed first


@pytest.mark.parametrize("method", ["lmd_plus", "sd"])
def test_generate_end_to_end_from_cache(webui, method):
    url, app = webui
    prompt, seed, steps = PROMPTS[2], 3, 2
    with one_torch_thread():
        status, body = _post(url, {"prompt": prompt, "method": method, "seed": str(seed),
                                   "steps": str(steps)})
        assert status == 200
        assert "Error:" not in body, body[-2000:]
        assert "<h3>Layout</h3>" in body and "<h3>Image</h3>" in body
        # The cache hands each response out once: a fresh App reads it anew.
        gen_boxes, bg_prompt, neg_prompt = tserver.App(app.args).layout(prompt)
        spec = {"prompt": prompt, "gen_boxes": gen_boxes, "bg_prompt": bg_prompt,
                "extra_neg_prompt": neg_prompt}
        want = tmethods.get_method(method).run(spec, app.bundle(), bg_seed=seed,
                                               num_inference_steps=steps)
    got = _page_image(body)
    assert got.shape == want.image.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want.image)
    assert _page_image(body, "Layout").shape == (512, 512, 3)
    assert ("<h3>Per-box images</h3>" in body) == bool(want.so_img_list)


def test_layout_matches_jax(cache_path, monkeypatch):
    monkeypatch.setattr(llm_client, "query_layout", _no_llm)
    monkeypatch.setattr(jllm_client, "query_layout", _no_llm)
    port, jax_app = tserver.App(_args(cache_path)), jserver.App(_args(cache_path))
    for prompt in PROMPTS:
        got, want = port.layout(prompt), jax_app.layout(prompt)
        assert got == want and got[0]
