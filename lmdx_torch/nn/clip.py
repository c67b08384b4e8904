"""CLIP text encoder (port of the JAX package's nn/clip.py), with the
transformers key names (text_model.embeddings..., text_model.encoder.layers.N...,
text_projection). Returns the last hidden state (the UNet conditioning) and
the pooled EOS-token embedding (the GLIGEN phrase embedding). OpenCLIP towers
take exact GELU: SD2.1's ViT-H returns the last hidden state as SD1.x's tower
does; the SDXL towers (the refiner's bigG, the base's CLIP ViT-L and bigG)
return the penultimate layer's hidden state under `penultimate_hidden`, and
bigG projects the pooled embedding with `text_projection` under
`use_text_projection`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPTextConfig
from .attention import Embedding, LayerNorm, Linear


def _act(name: str, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x, approximate="none")
    raise ValueError(name)


class CLIPAttention(nn.Module):
    """Self-attention over `heads` heads (the rank's share under a tensor
    split, `dist/mesh.py`: `tp_split` then holds its TensorSplit)."""

    tp_split = None

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.heads, self.head_dim = cfg.num_heads, d // cfg.num_heads
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def forward(self, x, mask):
        if self.tp_split is not None:
            x = self.tp_split.copy_in(x)
        b, l, _ = x.shape
        heads, hd = self.heads, self.head_dim

        def split(t):
            return t.reshape(b, l, heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / hd**0.5
        probs = torch.softmax(scores + mask, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, heads * hd)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    tp_split = None

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        if self.tp_split is not None:
            x = self.tp_split.copy_in(x)
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = Embedding(cfg.max_length, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(cfg, dtype) for _ in range(cfg.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32):
        super().__init__()
        self.config = cfg
        self.text_model = _TextModel(cfg, dtype)
        self.text_projection = (Linear(cfg.hidden_size, cfg.hidden_size, bias=False)
                                if cfg.use_text_projection else None)

    def forward(self, input_ids: torch.Tensor, eos_token_id: int = 49407):
        tm = self.text_model
        b, l = input_ids.shape
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :l])
        mask = torch.triu(torch.full((l, l), -1e9, dtype=torch.float32,
                                     device=input_ids.device), diagonal=1)
        penultimate = None
        for i, layer in enumerate(tm.encoder.layers):
            x = layer(x, mask)
            if i == len(tm.encoder.layers) - 2:
                penultimate = x
        x = tm.final_layer_norm(x)
        eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos_pos]
        if self.config.use_text_projection:
            pooled = self.text_projection(pooled)
        return (penultimate if self.config.penultimate_hidden else x), pooled
