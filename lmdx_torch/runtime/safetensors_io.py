"""Reader and writer of the safetensors format, with torch and the standard
library only.

The format: an unsigned 64-bit little-endian header length N, then N bytes
of JSON mapping each tensor's name to {"dtype", "shape", "data_offsets":
[begin, end]} (plus an optional "__metadata__" of strings), then the raw
little-endian bytes of every tensor, offsets counted from the end of the
header.

`read` maps the file (copy-on-write, so nothing is copied until a tensor is
written to or cast) and returns tensors that view the mapping; the mapping
lives as long as any of them. It refuses a header whose byte ranges overrun
the data, overlap, or disagree with their dtype and shape. `write` lays the
tensors out in name order after a header padded with spaces to 8 bytes, into
a temporary file that then replaces `path`: tensors still mapping the old
file keep its bytes (truncating a mapped file would fault their readers).
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20


def _header(buf, size: int) -> tuple[dict, int]:
    if size < 8:
        raise ValueError(f"safetensors file of {size} bytes has no header length")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > min(size - 8, _MAX_HEADER):
        raise ValueError(f"safetensors header of {n} bytes overruns the file ({size} bytes)")
    header = json.loads(bytes(buf[8:8 + n]))
    if not isinstance(header, dict):
        raise ValueError("safetensors header is not a JSON object")
    header.pop("__metadata__", None)
    return header, 8 + n


def read(path: str) -> dict[str, torch.Tensor]:
    """{name: tensor} of a .safetensors file, each a view of the mapped file."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            raise ValueError(f"{path}: empty file")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, start = _header(buf, size)
    data_size = size - start
    spans, out = [], {}
    for name, info in header.items():
        dtype = DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info.get('dtype')!r}; "
                             f"supported: {sorted(DTYPES)}")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        nbytes = math.prod(shape) * dtype.itemsize
        if not 0 <= begin <= end <= data_size or end - begin != nbytes:
            raise ValueError(f"{path}: {name} data_offsets [{begin}, {end}] do not hold "
                             f"{shape} {info['dtype']} inside {data_size} data bytes")
        spans.append((begin, end, name))
        if nbytes == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=nbytes // dtype.itemsize,
                                         offset=start + begin).reshape(shape)
    spans.sort()
    for (_, end, a), (begin, _, b) in zip(spans, spans[1:]):
        if begin < end:
            raise ValueError(f"{path}: the bytes of {a} and {b} overlap")
    return out


def write(tensors: dict[str, torch.Tensor], path: str,
          metadata: dict[str, str] | None = None) -> None:
    """Writes `tensors` (any device; contiguous copies are made on the host)
    to `path` in the safetensors format."""
    header, offset = {}, 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of {sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header = {"__metadata__": {str(k): str(v) for k, v in metadata.items()}, **header}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)
    os.replace(tmp, path)
