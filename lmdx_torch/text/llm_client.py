"""OpenAI-compatible LLM client for stage-1 layout generation (a copy of the
JAX package's text/llm_client.py).

Talks to either api.openai.com (chat models) or a self-hosted
OpenAI-compatible server (FastChat/vLLM etc. at localhost:8000) exactly like
the reference (utils/llm.py:27-93): chat models use /chat/completions, open
models use /completions with the raw template. Retries with backoff; results
flow through `LayoutCache` so benchmark runs are reproducible and offline.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import template as template_lib
from .cache import LayoutCache
from .parser import Layout, filter_boxes, parse_layout_response

OPEN_MODEL_MARKERS = ("vicuna", "llama", "freewilly", "stablebeluga", "mistral", "mixtral")

MODEL_ALIASES = {
    "gpt-3.5": "gpt-3.5-turbo",
    "vicuna": "vicuna-13b",
}


def canonical_model_name(model: str) -> str:
    return MODEL_ALIASES.get(model, model)


@dataclass
class LLMConfig:
    model: str
    template: str = template_lib.TEMPLATE_V0_1
    api_base: str = ""
    api_key: str = ""
    max_tokens: int = 900
    temperature: float = 0.25
    stop: str = template_lib.STOP
    headers: dict = field(default_factory=dict)

    def __post_init__(self):
        self.model = canonical_model_name(self.model)
        if not self.api_base:
            if self.is_chat_model:
                self.api_base = "https://api.openai.com/v1"
            else:
                self.api_base = "http://localhost:8000/v1"
        if self.api_key and "Authorization" not in self.headers:
            self.headers["Authorization"] = f"Bearer {self.api_key}"

    @property
    def is_chat_model(self) -> bool:
        return "gpt" in self.model


def get_llm_config(model: str, template_version: str = "v0.1", api_key: str = "",
                   api_base: str = "") -> LLMConfig:
    return LLMConfig(
        model=model,
        template=template_lib.TEMPLATES[template_version],
        api_key=api_key,
        api_base=api_base,
    )


def query_layout(prompt: str, config: LLMConfig, suffix: str = "",
                 max_attempts: int = 5, _post=None) -> str:
    """One raw LLM completion for `prompt` (no caching).

    `_post` injects a transport for testing; defaults to `requests.post`.
    """
    if _post is None:
        import requests

        _post = requests.post

    full_prompt = template_lib.get_full_prompt(config.template, prompt, suffix).strip()
    attempts = 0
    while True:
        if config.is_chat_model:
            r = _post(
                f"{config.api_base}/chat/completions",
                json={
                    "model": config.model,
                    "messages": [{"role": "user", "content": full_prompt}],
                    "max_tokens": config.max_tokens,
                    "temperature": config.temperature,
                    "stop": config.stop,
                },
                headers=config.headers,
            )
        else:
            r = _post(
                f"{config.api_base}/completions",
                json={
                    "model": config.model,
                    "prompt": full_prompt,
                    "max_tokens": config.max_tokens,
                    "temperature": config.temperature,
                    "stop": config.stop,
                },
                headers=config.headers,
            )
        if r.status_code == 200:
            break
        attempts += 1
        if attempts >= max_attempts:
            raise RuntimeError(f"LLM request failed after {attempts} attempts: {r.status_code}")
        time.sleep(min(60, 2**attempts))

    payload = r.json()
    if config.is_chat_model:
        return payload["choices"][0]["message"]["content"]
    return payload["choices"][0]["text"]


def query_layout_cached(prompt: str, config: LLMConfig, cache: LayoutCache, **kwargs) -> str:
    """Cache-through layout query (reference: utils/llm.py:96-110)."""
    response = cache.get(prompt)
    if response is not None:
        return response
    response = query_layout(prompt, config, **kwargs)
    cache.add(prompt, response)
    return response


def get_parsed_layout(prompt: str, config: LLMConfig, cache: LayoutCache | None = None,
                      max_attempts: int = 3, scale_boxes: bool = False, **kwargs) -> Layout:
    """Query + parse + sanitize, retrying on malformed responses.

    Returns a Layout whose gen_boxes are {'name', 'bounding_box'} dicts,
    matching the reference's get_parsed_layout (utils/llm.py:113-140).
    """
    last_err = None
    for _ in range(max_attempts):
        try:
            if cache is not None:
                text = query_layout_cached(prompt, config, cache, **kwargs)
            else:
                text = query_layout(prompt, config, **kwargs)
            layout = parse_layout_response(text, strict=True)
            boxes = [{"name": name, "bounding_box": list(box)} for name, box in layout.gen_boxes]
            layout.gen_boxes = filter_boxes(boxes, scale_boxes=scale_boxes)
            return layout
        except Exception as e:  # malformed response: retry with a fresh sample
            last_err = e
    raise RuntimeError(f"Failed to obtain a parseable layout for {prompt!r}") from last_err
