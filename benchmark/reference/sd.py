"""Plain float32 reference of the Stable Diffusion 1.x networks that the
grounded-generation path runs: the word-level tokenizer, the CLIP text tower,
GLIGEN's PositionNet, the conditional UNet (with GLIGEN's gated
self-attention fusers and exported cross-attention maps) and the VAE decoder.

Every function reads a configuration dict (`benchmark/configs/<name>.json`)
and a state dict of tensors under the diffusers / transformers key names;
weights are read as given and computed in float32 through `Prec`, so the
same code is the reference (`Prec("f32")`) and its lower-precision control.
Attention is materialised softmax(q k^T / sqrt(d)) v. The equations follow
the published SD1.x / GLIGEN networks with the project's conventions, which
the module docstrings of the program state too: the feed-forward GEGLU and
the GLIGEN fuser use the tanh form of GELU, the fuser queries only the
visual tokens, LayerNorm eps 1e-6 inside the transformer blocks.
"""

from __future__ import annotations

import hashlib
import html
import math
import re

import torch
import torch.nn.functional as F

from .prec import Prec

BOS_ID, EOS_ID, MAX_LENGTH = 49406, 49407, 77
_WORD_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[a-zA-Z]+|[0-9]|[^\s a-zA-Z0-9]+""",
    re.IGNORECASE)


# ---- tokenizer ---------------------------------------------------------------

def word_token_ids(text: str, vocab_size: int) -> list[int]:
    """The word-level tokenizer: one word one token, ids md5-hashed into
    [1000, BOS_ID), BOS first, EOS after and as padding to 77; folded into a
    vocabulary smaller than BOS_ID (test sizes)."""
    text = html.unescape(html.unescape(text))
    words = _WORD_RE.findall(re.sub(r"\s+", " ", text.strip()).lower())
    ids = [BOS_ID] + [1000 + int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
                      % (BOS_ID - 1000) for w in words]
    ids = ids[:MAX_LENGTH - 1] + [EOS_ID]
    ids += [EOS_ID] * (MAX_LENGTH - len(ids))
    if vocab_size < BOS_ID:
        ids = [i % vocab_size for i in ids]
    return ids


# ---- shared pieces -----------------------------------------------------------

def _w(P, name):
    return P[name].float()


def _lin(P, pr: Prec, name, x, bias=True):
    return pr.linear(x, _w(P, name + ".weight"), _w(P, name + ".bias") if bias else None)


def _ln(P, name, x, eps):
    return F.layer_norm(x.float(), x.shape[-1:], _w(P, name + ".weight"),
                        _w(P, name + ".bias"), eps)


def _gn(P, name, x, groups, eps):
    return F.group_norm(x.float(), groups, _w(P, name + ".weight"), _w(P, name + ".bias"), eps)


def _conv(P, pr: Prec, name, x, stride=1, padding=0):
    b = P.get(name + ".bias")
    return pr.conv(x, _w(P, name + ".weight"), b, stride=stride, padding=padding)


def attention(pr: Prec, q, k, v, heads):
    """(B, Lq, h*d), (B, Lk, h*d) -> (out (B, Lq, h*d), probs (B, h, Lq, Lk))."""
    b, lq, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    probs = torch.softmax(pr.mm(qh, kh.transpose(-1, -2)) * d ** -0.5, dim=-1)
    out = pr.mm(probs, vh)
    return out.transpose(1, 2).reshape(b, lq, inner), probs


# ---- CLIP text tower -----------------------------------------------------------

def clip_text(P, cfg, pr: Prec, ids: torch.Tensor):
    """ids (N, 77) -> (last hidden state (N, 77, D), pooled EOS state (N, D))."""
    c = cfg["clip"]
    n, length = ids.shape
    pre = "text_model."
    x = (_w(P, pre + "embeddings.token_embedding.weight")[ids]
         + _w(P, pre + "embeddings.position_embedding.weight")[None, :length])
    mask = torch.triu(torch.full((length, length), -1e9, device=ids.device), diagonal=1)
    heads, eps = c["num_heads"], c["layer_norm_eps"]
    d = c["hidden_size"] // heads
    for i in range(c["num_layers"]):
        lp = f"{pre}encoder.layers.{i}."
        h = _ln(P, lp + "layer_norm1", x, eps)
        q, k, v = (_lin(P, pr, lp + f"self_attn.{p}_proj", h) for p in "qkv")

        def split(t):
            return t.reshape(n, length, heads, d).transpose(1, 2)

        s = pr.mm(split(q), split(k).transpose(-1, -2)) / d ** 0.5 + mask
        o = pr.mm(torch.softmax(s, dim=-1), split(v)).transpose(1, 2).reshape(n, length, -1)
        x = x + _lin(P, pr, lp + "self_attn.out_proj", o)
        h = _lin(P, pr, lp + "mlp.fc1", _ln(P, lp + "layer_norm2", x, eps))
        if c["hidden_act"] == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h)
        x = x + _lin(P, pr, lp + "mlp.fc2", h)
    x = _ln(P, pre + "final_layer_norm", x, eps)
    eos = EOS_ID % c["vocab_size"] if c["vocab_size"] < BOS_ID else EOS_ID
    pos = (ids == eos).int().argmax(dim=-1)
    return x, x[torch.arange(n, device=x.device), pos]


def encode_text(P, cfg, pr: Prec, texts: list[str], device):
    ids = torch.tensor([word_token_ids(t, cfg["clip"]["vocab_size"]) for t in texts],
                       dtype=torch.int64, device=device)
    return clip_text(P, cfg, pr, ids)


# ---- GLIGEN PositionNet --------------------------------------------------------

def position_net(P, cfg, pr: Prec, boxes, masks, phrase):
    """(B, M, 4) boxes, (B, M) validity, (B, M, D) phrase embeddings ->
    grounding tokens (B, M, cross_attention_dim)."""
    freqs = cfg["unet"]["gligen_fourier_freqs"]
    boxes, masks, phrase = pr.q(boxes), masks.float(), pr.q(phrase)
    bands = 100.0 ** (torch.arange(freqs, device=boxes.device, dtype=torch.float32) / freqs)
    emb = bands[None, None, None, :] * boxes[..., None]               # (B, M, 4, F)
    emb = torch.stack([torch.sin(emb), torch.cos(emb)], dim=-1)       # (B, M, 4, F, 2)
    xyxy = emb.permute(0, 1, 3, 4, 2).reshape(*boxes.shape[:2], -1)
    m = masks[..., None]
    phrase = phrase * m + (1 - m) * _w(P, "null_positive_feature")
    xyxy = xyxy * m + (1 - m) * _w(P, "null_position_feature")
    h = torch.cat([phrase, xyxy], dim=-1)
    h = F.silu(_lin(P, pr, "linears.0", h))
    h = F.silu(_lin(P, pr, "linears.2", h))
    return _lin(P, pr, "linears.4", h)


# ---- UNet ------------------------------------------------------------------------

def timestep_features(t: torch.Tensor, dim: int, flip: bool, shift: float):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip else [sin, cos], dim=-1)


def _resnet(P, pr, name, x, temb, groups, eps):
    h = _conv(P, pr, name + ".conv1", F.silu(_gn(P, name + ".norm1", x, groups, eps)), padding=1)
    if temb is not None:
        h = h + _lin(P, pr, name + ".time_emb_proj", F.silu(temb))[:, :, None, None]
    h = _conv(P, pr, name + ".conv2", F.silu(_gn(P, name + ".norm2", h, groups, eps)), padding=1)
    if name + ".conv_shortcut.weight" in P:
        x = _conv(P, pr, name + ".conv_shortcut", x)
    return x + h


def _geglu_ff(P, pr, name, x):
    h, gate = _lin(P, pr, name + ".net.0.proj", x).chunk(2, dim=-1)
    return _lin(P, pr, name + ".net.2", h * F.gelu(gate, approximate="tanh"))


class _Ctx:
    """One UNet call's conditioning and tap request."""

    def __init__(self, context, objs, tap_names, cond_only, tap_token_index):
        self.context, self.objs = context, objs
        self.tap_names = tap_names
        self.cond_only, self.tap_token_index = cond_only, tap_token_index
        self.taps = {}


def _block(P, pr, name, x, heads, tap_name, ctx: _Ctx):
    h = _ln(P, name + ".norm1", x, 1e-6)
    q, k, v = (_lin(P, pr, name + f".attn1.to_{p}", h, bias=False) for p in "qkv")
    x = x + _lin(P, pr, name + ".attn1.to_out.0", attention(pr, q, k, v, heads)[0])
    if ctx.objs is not None and name + ".fuser.alpha_attn" in P:
        f = name + ".fuser"
        n_vis = x.shape[1]
        objs = _lin(P, pr, f + ".linear", ctx.objs)
        h = _ln(P, f + ".norm1", torch.cat([x, objs], dim=1), 1e-6)
        q = _lin(P, pr, f + ".attn.to_q", h[:, :n_vis], bias=False)
        k = _lin(P, pr, f + ".attn.to_k", h, bias=False)
        v = _lin(P, pr, f + ".attn.to_v", h, bias=False)
        a = _lin(P, pr, f + ".attn.to_out.0", attention(pr, q, k, v, heads)[0])
        x = x + torch.tanh(_w(P, f + ".alpha_attn")) * a
        x = x + torch.tanh(_w(P, f + ".alpha_dense")) * _geglu_ff(
            P, pr, f + ".ff", _ln(P, f + ".norm2", x, 1e-6))
    h = _ln(P, name + ".norm2", x, 1e-6)
    q = _lin(P, pr, name + ".attn2.to_q", h, bias=False)
    k = _lin(P, pr, name + ".attn2.to_k", ctx.context, bias=False)
    v = _lin(P, pr, name + ".attn2.to_v", ctx.context, bias=False)
    out, probs = attention(pr, q, k, v, heads)
    if tap_name in ctx.tap_names:
        export = probs[probs.shape[0] // 2:] if ctx.cond_only else probs
        if ctx.tap_token_index is not None:
            idx = ctx.tap_token_index.long().view(-1, 1, 1, 1).expand(*export.shape[:-1], 1)
            export = torch.gather(export, -1, idx)
        ctx.taps[tap_name] = export
    x = x + _lin(P, pr, name + ".attn2.to_out.0", out)
    return x + _geglu_ff(P, pr, name + ".ff", _ln(P, name + ".norm3", x, 1e-6))


def _transformer(P, pr, name, x, heads, depth, groups, linear_proj, tap_prefix, ctx):
    b, c, hh, ww = x.shape
    h = _gn(P, name + ".norm", x, groups, 1e-6)
    if linear_proj:
        y = _lin(P, pr, name + ".proj_in", h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
    else:
        y = _conv(P, pr, name + ".proj_in", h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    for k in range(depth):
        y = _block(P, pr, f"{name}.transformer_blocks.{k}", y, heads, f"{tap_prefix}_{k}", ctx)
    if linear_proj:
        y = _lin(P, pr, name + ".proj_out", y).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    else:
        y = _conv(P, pr, name + ".proj_out", y.reshape(b, hh, ww, c).permute(0, 3, 1, 2))
    return y + x


def unet(P, cfg, pr: Prec, sample, t, context, objs=None, tap_names=(), cond_only=False,
         tap_token_index=None, stop_after_taps=False):
    """sample (B, H, W, 4) NHWC, t a timestep (or one per row), context (B, 77, D),
    objs (B, M, D) or None -> (eps (B, H, W, 4) or None, {tap name: probs}).
    A tap name is "<place>_<block>_<attention>_<transformer>"; `cond_only`
    keeps the second half of the batch, `tap_token_index` (one per exported
    row) one token column. `stop_after_taps` ends after the last tapped
    block (eps None)."""
    u = cfg["unet"]
    ch, groups, lpb = u["block_out_channels"], u["norm_num_groups"], u["layers_per_block"]
    heads = u["num_attention_heads"]
    depth_cfg = u["transformer_layers_per_block"]
    lin_proj = u["use_linear_projection"]

    def depth(level):
        return depth_cfg if isinstance(depth_cfg, int) else depth_cfg[level]

    ctx = _Ctx(pr.q(context), None if objs is None else pr.q(objs), set(tap_names),
               cond_only, tap_token_index)
    last = None
    if stop_after_taps and tap_names:
        order = {"down": 0, "mid": 1, "up": 2}
        last = max(((order[n.split("_")[0]], int(n.split("_")[1])) for n in tap_names))
    x = pr.q(sample).permute(0, 3, 1, 2)
    tt = torch.as_tensor(t, device=x.device).float()
    tt = tt.expand(x.shape[0]) if tt.dim() == 0 else tt
    temb = timestep_features(tt, ch[0], u["flip_sin_to_cos"], u["freq_shift"])
    temb = _lin(P, pr, "time_embedding.linear_2",
                F.silu(_lin(P, pr, "time_embedding.linear_1", temb)))
    x = _conv(P, pr, "conv_in", x, padding=1)
    residuals = [x]
    n_levels = len(ch)
    for i, kind in enumerate(u["down_block_types"]):
        pre = f"down_blocks.{i}"
        for j in range(lpb):
            x = _resnet(P, pr, f"{pre}.resnets.{j}", x, temb, groups, 1e-5)
            if kind == "CrossAttnDownBlock2D":
                x = _transformer(P, pr, f"{pre}.attentions.{j}", x, heads[i], depth(i), groups,
                                 lin_proj, f"down_{i}_{j}", ctx)
            residuals.append(x)
        if i < n_levels - 1:
            x = _conv(P, pr, f"{pre}.downsamplers.0.conv", x, stride=2, padding=1)
            residuals.append(x)
        if last == (0, i):
            return None, ctx.taps
    x = _resnet(P, pr, "mid_block.resnets.0", x, temb, groups, 1e-5)
    x = _transformer(P, pr, "mid_block.attentions.0", x, heads[-1], depth(n_levels - 1),
                     groups, lin_proj, "mid_0_0", ctx)
    x = _resnet(P, pr, "mid_block.resnets.1", x, temb, groups, 1e-5)
    if last == (1, 0):
        return None, ctx.taps
    for i, kind in enumerate(u["up_block_types"]):
        level = n_levels - 1 - i
        pre = f"up_blocks.{i}"
        for j in range(lpb + 1):
            x = torch.cat([x, residuals.pop()], dim=1)
            x = _resnet(P, pr, f"{pre}.resnets.{j}", x, temb, groups, 1e-5)
            if kind == "CrossAttnUpBlock2D":
                x = _transformer(P, pr, f"{pre}.attentions.{j}", x, heads[level], depth(level),
                                 groups, lin_proj, f"up_{i}_{j}", ctx)
        if i < n_levels - 1:
            x = _conv(P, pr, f"{pre}.upsamplers.0.conv",
                      F.interpolate(x, scale_factor=2.0, mode="nearest"), padding=1)
        if last == (2, i):
            return None, ctx.taps
    x = _conv(P, pr, "conv_out", F.silu(_gn(P, "conv_norm_out", x, groups, 1e-5)), padding=1)
    return x.permute(0, 2, 3, 1), ctx.taps


# ---- VAE decoder -------------------------------------------------------------------

def vae_decode(P, cfg, pr: Prec, latents):
    """Scaled latents (B, h, w, 4) -> uint8 images (B, 8h, 8w, 3)."""
    v = cfg["vae"]
    g = v["norm_num_groups"]
    z = pr.q(latents).permute(0, 3, 1, 2) / v["scaling_factor"]
    z = _conv(P, pr, "post_quant_conv", z)
    x = _conv(P, pr, "decoder.conv_in", z, padding=1)
    x = _resnet(P, pr, "decoder.mid_block.resnets.0", x, None, g, 1e-6)
    a = "decoder.mid_block.attentions.0"
    b, c, hh, ww = x.shape
    y = _gn(P, a + ".group_norm", x, g, 1e-6).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    q, k, vv = (_lin(P, pr, f"{a}.to_{p}", y) for p in "qkv")
    probs = torch.softmax(pr.mm(q, k.transpose(-1, -2)) / c ** 0.5, dim=-1)
    y = _lin(P, pr, a + ".to_out.0", pr.mm(probs, vv))
    x = x + y.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    x = _resnet(P, pr, "decoder.mid_block.resnets.1", x, None, g, 1e-6)
    n_up = len(v["block_out_channels"])
    for i in range(n_up):
        for j in range(v["layers_per_block"] + 1):
            x = _resnet(P, pr, f"decoder.up_blocks.{i}.resnets.{j}", x, None, g, 1e-6)
        if i < n_up - 1:
            x = _conv(P, pr, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(x, scale_factor=2.0, mode="nearest"), padding=1)
    x = _conv(P, pr, "decoder.conv_out", F.silu(_gn(P, "decoder.conv_norm_out", x, g, 1e-6)),
              padding=1)
    img = torch.clamp(x.permute(0, 2, 3, 1) / 2 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0)


def latent_hw(cfg: dict) -> tuple[int, int]:
    """The latent grid: the image over the VAE's 2^(levels - 1) downscale."""
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return cfg["height"] // f, cfg["width"] // f
