"""Sequential-read JSON cache for LLM layout responses (a copy of the JAX
package's text/cache.py: the two read and write the same files).

File format is identical to the reference's `cache/cache_*.json`
(utils/cache.py): a JSON object mapping prompt -> list of raw response
strings. Repeated queries for the same prompt consume successive cached
values, so a benchmark with repeated prompts replays distinct responses in
order; when the list is exhausted, the caller queries the LLM and the new
response is appended (write-through).

Unlike the reference (module-level globals, utils/cache.py:7-23), this is a
class so multiple caches can coexist (e.g. per template/model) and tests don't
leak state.
"""

from __future__ import annotations

import json
import os
import threading


class LayoutCache:
    def __init__(self, path: str, allow_nonexist: bool = True):
        self.path = path
        self._data: dict[str, list[str]] = {}
        self._read_index: dict[str, int] = {}
        self._queries: dict[str, list[str]] = {}
        self._lock = threading.Lock()
        if not allow_nonexist and not os.path.exists(path):
            raise FileNotFoundError(path)
        if os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    # -- accounting ---------------------------------------------------------
    def reset_access(self) -> None:
        with self._lock:
            self._read_index = {}
            self._queries = {}

    def values_accessed(self) -> int:
        return sum(self._read_index.values())

    def __contains__(self, prompt: str) -> bool:
        return prompt in self._data and bool(self._data[prompt])

    def __len__(self) -> int:
        return len(self._data)

    # -- sequential read / write-through ------------------------------------
    def get(self, prompt: str) -> str | None:
        """Next unread cached response for `prompt`, or None on miss."""
        with self._lock:
            items = self._data.setdefault(prompt, [])
            index = self._read_index.setdefault(prompt, 0)
            if index < len(items):
                self._read_index[prompt] = index + 1
                self._queries.setdefault(prompt, []).append(items[index])
                return items[index]
            return None

    def add(self, prompt: str, response: str) -> str:
        """Append a fresh response and persist immediately (write-through)."""
        with self._lock:
            self._read_index[prompt] = self._read_index.get(prompt, 0) + 1
            self._data.setdefault(prompt, []).append(response)
            self._save_locked()
        return response

    def _save_locked(self) -> None:
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=4)
        os.replace(tmp, self.path)


def cache_filename(prompt_type: str, template_version: str, model: str,
                   cache_dir: str = "cache") -> str:
    """Canonical cache path; matches the reference naming convention
    (generate.py:177, prompt_batch.py:43):
    cache/cache_{type minus 'lmd_'}_{template}_{model}.json,
    e.g. cache/cache_lmd_v0.1_gpt-4.json."""
    base = f"cache_{prompt_type.replace('lmd_', '')}_{template_version}_{model}.json"
    return os.path.join(cache_dir, base)
