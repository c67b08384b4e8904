"""Tokenization and phrase -> token-index mapping.

The guidance losses need, for every grounded phrase, the *token positions* of
that phrase inside the conditional prompt (reference utils/guidance.py:32-89),
including two quirks that must be preserved exactly:

- phrases not found in the prompt are appended as "| phrase" suffixes and the
  augmented prompt is what gets encoded (guidance.py:35-36);
- the per-phrase "word" (the guidance word, last word of the phrase —
  utils/parse.py:326-328) maps to a single token index used for single-token
  attention taps and ref-CA transfer.

Tokenizers are pluggable:

- `ClipBpeTokenizer`: a from-scratch implementation of the CLIP BPE scheme
  (lowercase + whitespace cleanup, word regex, character-level BPE with
  `</w>` end-of-word markers) loading `vocab.json`/`merges.txt` from a
  checkpoint directory. Matches the ids the reference gets from
  `CLIPTokenizer` so converted CLIP weights see the right streams.
- `WordTokenizer`: a deterministic word-level fallback (stable hash ids) for
  weightless runs and tests — every word is one token, so phrase-index
  structure is exercised without vocab files.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import os
import re
from dataclasses import dataclass

BOS_ID = 49406
EOS_ID = 49407
MAX_LENGTH = 77

# CLIP's pattern uses \p{L}/\p{N}; python re lacks them — ASCII classes cover
# the benchmark vocabulary (English nouns/adjectives).
_BASIC_WORD_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\s a-zA-Z0-9]+""",
    re.IGNORECASE,
)


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


class WordTokenizer:
    """Deterministic word-level tokenizer: 1 word = 1 token.

    Ids are stable hashes into [1000, 49406); token *strings* are the words
    themselves, so phrase-index substring matching behaves like the real
    tokenizer on simple vocabulary.
    """

    bos_token = "<|startoftext|>"
    eos_token = "<|endoftext|>"
    bos_id = BOS_ID
    eos_id = EOS_ID
    model_max_length = MAX_LENGTH

    def tokenize(self, text: str) -> list[str]:
        return _BASIC_WORD_RE.findall(_clean_text(text))

    def token_to_id(self, token: str) -> int:
        if token == self.bos_token:
            return self.bos_id
        if token == self.eos_token:
            return self.eos_id
        h = int.from_bytes(hashlib.md5(token.encode()).digest()[:4], "little")
        return 1000 + h % (BOS_ID - 1000)

    def encode(self, text: str, pad_to: int | None = None) -> list[int]:
        ids = [self.bos_id] + [self.token_to_id(t) for t in self.tokenize(text)]
        ids = ids[: (pad_to or MAX_LENGTH) - 1] + [self.eos_id]
        if pad_to:
            ids = ids + [self.eos_id] * (pad_to - len(ids))
        return ids

    def token_map(self, text: str) -> list[str]:
        """Unpadded token strings incl. bos/eos (reference get_token_map)."""
        toks = self.tokenize(text)
        toks = toks[: MAX_LENGTH - 2]
        return [self.bos_token, *toks, self.eos_token]


class ClipBpeTokenizer:
    """CLIP BPE tokenizer (from scratch) loading vocab/merges files.

    Accepts a HF `tokenizer/` directory (vocab.json + merges.txt) or the
    OpenAI `bpe_simple_vocab_16e6.txt(.gz)` merge list.
    """

    bos_token = "<|startoftext|>"
    eos_token = "<|endoftext|>"
    bos_id = BOS_ID
    eos_id = EOS_ID
    model_max_length = MAX_LENGTH

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, str] = {}
        # Special-token ids come from the vocab itself (full CLIP vocabs put
        # them at 49406/49407; reduced test vocabs may not).
        self.bos_id = vocab.get(self.bos_token, BOS_ID)
        self.eos_id = vocab.get(self.eos_token, EOS_ID)

    @classmethod
    def from_dir(cls, path: str) -> "ClipBpeTokenizer":
        vocab_path = os.path.join(path, "vocab.json")
        merges_path = os.path.join(path, "merges.txt")
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path) as f:
            for line in f.read().split("\n"):
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_openai_bpe(cls, path: str) -> "ClipBpeTokenizer":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        chars = [chr(i) for i in range(33, 127)] + [chr(i) for i in range(161, 256)]
        vocab = chars + [c + "</w>" for c in chars]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        return cls({t: i for i, t in enumerate(vocab)}, merges)

    def token_id_or_eos(self, token: str) -> int:
        """Full CLIP vocabs cover every char+</w>; partial test vocabs fall
        back to eos instead of raising."""
        return self.encoder.get(token, self.encoder.get(self.eos_token, 0))

    def _bpe(self, word: str) -> list[str]:
        if word in self.cache:
            return self.cache[word].split(" ")
        pieces = list(word[:-1]) + [word[-1] + "</w>"]
        while len(pieces) > 1:
            pairs = {(pieces[i], pieces[i + 1]) for i in range(len(pieces) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(pieces):
                if i < len(pieces) - 1 and (pieces[i], pieces[i + 1]) == best:
                    merged.append(pieces[i] + pieces[i + 1])
                    i += 2
                else:
                    merged.append(pieces[i])
                    i += 1
            pieces = merged
        self.cache[word] = " ".join(pieces)
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in _BASIC_WORD_RE.findall(_clean_text(text)):
            out.extend(self._bpe(word))
        return out

    def token_to_id(self, token: str) -> int:
        return self.token_id_or_eos(token)

    def encode(self, text: str, pad_to: int | None = None) -> list[int]:
        ids = [self.bos_id] + [self.token_to_id(t) for t in self.tokenize(text)]
        ids = ids[: (pad_to or MAX_LENGTH) - 1] + [self.eos_id]
        if pad_to:
            ids = ids + [self.eos_id] * (pad_to - len(ids))
        return ids

    def token_map(self, text: str) -> list[str]:
        toks = self.tokenize(text)[: MAX_LENGTH - 2]
        return [self.bos_token, *toks, self.eos_token]


@dataclass
class PhraseIndices:
    object_positions: list  # per phrase: list of token indices in the prompt
    word_token_indices: list  # per phrase: the guidance word's token index
    prompt: str  # possibly suffix-augmented prompt (encode THIS one)


def get_phrase_indices(
    tokenizer,
    prompt: str,
    phrases: list[str],
    words: list[str] | None = None,
    add_suffix_if_not_found: bool = False,
) -> PhraseIndices:
    """Locate each phrase's token positions inside the prompt.

    Matching is done on joined token-string sequences, exactly like the
    reference (guidance.py:43-79): find the phrase token subsequence within
    the prompt token sequence; the "word" index is the position of the word's
    last token within the phrase occurrence.
    """
    if add_suffix_if_not_found:
        for phrase in phrases:
            if phrase not in prompt:
                prompt += "| " + phrase

    token_map = tokenizer.token_map(prompt)
    token_map_str = " ".join(token_map)

    object_positions = []
    word_token_indices = []
    for obj_ind, phrase in enumerate(phrases):
        phrase_tokens = tokenizer.token_map(phrase)[1:-1]  # strip bos/eos
        phrase_str = " ".join(phrase_tokens)
        if phrase_str not in token_map_str:
            raise ValueError(
                f"phrase {phrase!r} (tokens {phrase_str!r}) not found in prompt "
                f"{prompt!r}; pass add_suffix_if_not_found=True"
            )
        first_index = len(
            token_map_str[: token_map_str.index(phrase_str) - 1].split(" ")
        ) if token_map_str.index(phrase_str) > 0 else 0
        positions = list(range(first_index, first_index + len(phrase_tokens)))
        object_positions.append(positions)

        if words is not None:
            word_tokens = tokenizer.token_map(words[obj_ind])[1:-1]
            word_token_indices.append(
                first_index + phrase_tokens.index(word_tokens[-1])
            )
        else:
            word_token_indices.append(positions[-1])

    return PhraseIndices(
        object_positions=object_positions,
        word_token_indices=word_token_indices,
        prompt=prompt,
    )


@functools.lru_cache(maxsize=1)
def default_tokenizer():
    """Best available tokenizer: CLIP BPE if vocab files are present in known
    locations, the word-level fallback otherwise."""
    candidates = [
        os.environ.get("LMDX_TOKENIZER_DIR", ""),
        os.path.expanduser("~/.cache/lmdx/tokenizer"),
    ]
    for path in candidates:
        if path and os.path.exists(os.path.join(path, "vocab.json")):
            return ClipBpeTokenizer.from_dir(path)
    bpe = os.environ.get("LMDX_CLIP_BPE", "")
    if bpe and os.path.exists(bpe):
        return ClipBpeTokenizer.from_openai_bpe(bpe)
    return WordTokenizer()
