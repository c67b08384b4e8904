"""Two places where the port's host-side choices must equal the JAX
package's: the tokenizer search path (`default_tokenizer`) and the flash
kernel's dispatch gate (`kernel_supported` against `_kernel_supported`).

A different tokenizer changes every token id and phrase position; a
different gate sends a layer to the kernel on one side and to plain math on
the other. Both checks are exact.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx.text import tokens as jtok
from lmdx_torch.nn.kernels import flash_attention as tfa
from lmdx_torch.text import tokens as ttok

# A tiny CLIP BPE: characters and merges building "cat</w>" and "dog</w>";
# "big" falls apart into three tokens, which the word-level fallback would
# count as one.
MERGES = [("c", "a"), ("ca", "t</w>"), ("d", "o"), ("do", "g</w>"), ("a", "</w>")]
VOCAB = ["c", "a", "t", "d", "o", "g", "b", "i", "t</w>", "g</w>", "a</w>",
         "ca", "cat</w>", "do", "dog</w>", "<|startoftext|>", "<|endoftext|>"]


@pytest.fixture
def home_tokenizer(tmp_path, monkeypatch):
    """HOME holding a CLIP tokenizer under .cache/lmdx/tokenizer, no
    environment override; both packages' cached tokenizers are dropped
    before and after, so no later test sees this one."""
    path = tmp_path / ".cache" / "lmdx" / "tokenizer"
    path.mkdir(parents=True)
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(VOCAB)}))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("LMDX_TOKENIZER_DIR", raising=False)
    monkeypatch.delenv("LMDX_CLIP_BPE", raising=False)
    jtok.default_tokenizer.cache_clear()
    ttok.default_tokenizer.cache_clear()
    yield
    jtok.default_tokenizer.cache_clear()
    ttok.default_tokenizer.cache_clear()


def test_default_tokenizer_reads_the_home_cache_like_jax(home_tokenizer):
    jt, tt = jtok.default_tokenizer(), ttok.default_tokenizer()
    assert isinstance(jt, jtok.ClipBpeTokenizer)
    assert isinstance(tt, ttok.ClipBpeTokenizer)
    prompt = "a big cat and a dog"
    assert tt.encode(prompt, pad_to=ttok.MAX_LENGTH) == list(
        jt.encode(prompt, pad_to=jtok.MAX_LENGTH))
    args = (prompt, ["a big cat", "a dog"])
    want = jtok.get_phrase_indices(jt, *args, words=["cat", "dog"])
    got = ttok.get_phrase_indices(tt, *args, words=["cat", "dog"])
    assert got.object_positions == want.object_positions == [[1, 2, 3, 4, 5], [9, 10]]
    assert got.word_token_indices == want.word_token_indices
    assert got.prompt == want.prompt


# (Lq, Lk, head_dim): every attention of SD1.x at 512x512 (self, GLIGEN fuser
# with 30 grounding tokens, 77-token cross-attention; 8 heads), the 768x768
# attentions, and shapes each of the other clauses refuses.
SHAPES_512 = [(n, n + e, d) for n, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))
              for e in (0, 30)] + [(n, 77, d) for n, d in ((4096, 40), (1024, 80),
                                                           (256, 160), (64, 160))]
SHAPES_768 = [(9216, 9216, 40), (9216, 9246, 40), (2304, 2304, 80), (2304, 2334, 80),
              (576, 576, 160), (144, 144, 160), (9216, 77, 40)]
SHAPES_OTHER = [(4096, 4096, 64), (4, 512, 40), (512, 512, 264), (512, 255, 40)]


def _both(lq, lk, d):
    q = torch.empty((1, 8, lq, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 8, lk, d), dtype=torch.bfloat16, device="meta")
    jq = jax.ShapeDtypeStruct((1, 8, lq, d), jnp.bfloat16)
    jk = jax.ShapeDtypeStruct((1, 8, lk, d), jnp.bfloat16)
    return tfa.kernel_supported(q, k), jfa._kernel_supported(jq, jk)


@pytest.mark.parametrize("shape", SHAPES_512 + SHAPES_768 + SHAPES_OTHER,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_supported_equals_the_jax_gate(shape):
    got, want = _both(*shape)
    assert got == want
    if shape in SHAPES_512:
        assert got == (shape[1] >= 256)     # 512x512: only the size of KV decides
    if shape[:2] == (9216, 9216):
        assert not got                      # 768x768, d 40: plain math on both sides


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_kernel_supported_equals_the_jax_gate_across_the_12_mib_edge(d):
    # Sweep KV across the size rule's edge: both sides flip at the same row.
    results = [_both(512, lk, d) for lk in range(3000, 6400, 7)]
    assert all(got == want for got, want in results)
    assert {got for got, _ in results} == {True, False}
