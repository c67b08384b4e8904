"""Minimal self-hosted WebUI for two-stage grounded generation (port of the
JAX package's webui/server.py, same page, form and flags).

A stdlib HTTP server exposing the whole pipeline: prompt -> stage-1 layout
(cache or LLM) -> layout visualization -> stage-2 grounded generation ->
image.

    python -m lmdx_torch.webui.server --port 7860 \\
        --cache-path cache/cache_demo_v0.1_gpt-4.json

It serves `--sd-model` (default: SD1.4+GLIGEN, 512x512) on the card, or on
the CPU with `--cpu`. Layouts come from the cache (offline) or a configured
LLM endpoint; the method, seed and steps are form inputs. LMDX_PACKED_ATTENTION,
LMDX_FUSED_HEADS and LMDX_PALLAS_GROUPNORM choose the opt-in kernels, as in
the stage-2 CLI. Generation is serialized: the server holds one bundle, and
one request at a time runs on it.
"""

from __future__ import annotations

import argparse
import base64
import html
import io
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

_PAGE = """<!doctype html><html><head><title>lmdx</title><style>
body {{ font-family: sans-serif; max-width: 760px; margin: 2em auto; }}
textarea, select, input {{ width: 100%; margin: 4px 0; }}
img {{ image-rendering: pixelated; border: 1px solid #ccc; margin: 4px; }}
pre {{ background: #f5f5f5; padding: 8px; overflow-x: auto; }}
</style></head><body>
<h2>lmdx — LLM-grounded diffusion</h2>
<form method="post" action="/generate">
<label>Prompt</label><textarea name="prompt" rows="2">{prompt}</textarea>
<label>Method</label><select name="method">{methods}</select>
<label>Seed</label><input name="seed" value="{seed}">
<label>Steps</label><input name="steps" value="{steps}">
<button type="submit">Generate</button>
</form>
{result}
</body></html>"""


def _img_tag(arr, width=256):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f'<img src="data:image/png;base64,{b64}" width="{width}">'


class Handler(BaseHTTPRequestHandler):
    app = None  # set by main()

    def _respond(self, body: str, code: int = 200):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        print(f"[webui] {fmt % args}")

    def do_GET(self):
        self._respond(self.app.page())

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        form = parse_qs(self.rfile.read(length).decode())
        try:
            result = self.app.generate(
                prompt=form.get("prompt", [""])[0],
                method=form.get("method", ["lmd_plus"])[0],
                seed=int(form.get("seed", ["1"])[0]),
                steps=int(form.get("steps", ["50"])[0]),
            )
        except Exception as e:  # surface errors in the page
            result = (f"<pre>Error: {html.escape(str(e))}\n"
                      f"{html.escape(traceback.format_exc())}</pre>")
        self._respond(self.app.page(result=result,
                                    prompt=form.get("prompt", [""])[0]))


class App:
    def __init__(self, args):
        self.args = args
        self._bundle = None
        self._cache = None
        self._lock = threading.Lock()

    def page(self, result: str = "", prompt: str = "") -> str:
        from .. import methods as methods_lib

        options = "".join(
            f'<option value="{m}"{" selected" if m == "lmd_plus" else ""}>{m}</option>'
            for m in sorted(methods_lib.METHODS))
        return _PAGE.format(methods=options, result=result,
                            prompt=html.escape(prompt or "a cat on the left of a dog"),
                            seed=1, steps=self.args.steps)

    def bundle(self):
        """The served bundle, built on first use with the opt-in kernels the
        environment names."""
        with self._lock:
            if self._bundle is None:
                from ..config import kernel_options_from_env
                from ..runtime.models import load_bundle

                self._bundle = load_bundle(self.args.sd_model,
                                           device="cpu" if self.args.cpu else None,
                                           kernels=kernel_options_from_env())
            return self._bundle

    def layout(self, prompt: str):
        from ..text.cache import LayoutCache
        from ..text.llm_client import get_llm_config, get_parsed_layout
        from ..text.parser import filter_boxes

        with self._lock:
            if self._cache is None and self.args.cache_path:
                self._cache = LayoutCache(self.args.cache_path)
        config = get_llm_config(self.args.llm_model)
        layout = get_parsed_layout(prompt, config, cache=self._cache)
        return filter_boxes(layout.gen_boxes), layout.bg_prompt, layout.neg_prompt

    def generate(self, prompt: str, method: str, seed: int, steps: int) -> str:
        from .. import methods as methods_lib
        from ..utils import vis

        gen_boxes, bg_prompt, neg_prompt = self.layout(prompt)
        spec = {"prompt": prompt, "gen_boxes": gen_boxes,
                "bg_prompt": bg_prompt, "extra_neg_prompt": neg_prompt}
        boxes_img = vis.draw_boxes(gen_boxes, bg_prompt=bg_prompt, neg_prompt=neg_prompt)
        run = methods_lib.get_method(method).run
        bundle = self.bundle()
        with self._lock:
            result = run(spec, bundle, bg_seed=seed, num_inference_steps=steps)
        parts = [
            f"<h3>Layout</h3>{_img_tag(np.asarray(boxes_img))}",
            f"<h3>Image</h3>{_img_tag(result.image)}",
        ]
        if result.so_img_list:
            parts.append("<h3>Per-box images</h3>" + "".join(
                _img_tag(im, width=128) for im in result.so_img_list))
        parts.append(f"<pre>{html.escape(json.dumps(spec, default=str, indent=1))}</pre>")
        return "".join(parts)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=7860, type=int)
    parser.add_argument("--sd-model", default="gligen/diffusers-generation-text-box")
    parser.add_argument("--llm-model", default="gpt-4")
    parser.add_argument("--cache-path", default=None)
    parser.add_argument("--steps", default=50, type=int)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    Handler.app = App(args)
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"[webui] serving on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
