"""Plain float32 reference of Segment Anything (ViT-B) as the segmenter of the
grounded-generation path prompts it: the image (uint8, resized bilinearly to
the model size and normalised), the prompt (a box as two corner points, or
one foreground point), the ViTDet image encoder with windowed attention and
decomposed relative positions, the prompt encoder and the two-way mask
decoder. Returns the three candidate masks' low-resolution logits and their
IoU scores. Key names are transformers' `SamModel`'s.

The project's SAM departs from transformers' in two places, and the
reference follows the project: the first two-way block adds its
self-attention residual, and the two up-scaling transposed convolutions
apply their 2x2 kernels mirrored.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .prec import Prec
from .sd import _lin, _ln, _w

SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)


def prompt_points(cfg, n_images, oh, ow, input_points=None, input_boxes=None):
    """Normalised prompts -> (points (n, 2, 2) in [0, 1], labels (n, 2)): a
    box's corners as integer pixels of the (oh, ow) image, rescaled to the
    model size and shifted to pixel centres (labels 2, 3); a point rides slot
    0 (label 1) with slot 1 padding (label -1)."""
    size = cfg["sam"]["image_size"]
    points = np.zeros((n_images, 2, 2), np.float32)
    labels = np.full((n_images, 2), -1, np.int64)
    for i in range(n_images):
        if input_boxes is not None:
            [box] = input_boxes[i]
            x0, y0 = round(box[0] * ow), round(box[1] * oh)
            x1, y1 = x0 + round((box[2] - box[0]) * ow), y0 + round((box[3] - box[1]) * oh)
            x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, ow), min(y1, oh)
            sx, sy = size / ow, size / oh
            points[i] = [((x0 * sx + 0.5) / size, (y0 * sy + 0.5) / size),
                         ((x1 * sx + 0.5) / size, (y1 * sy + 0.5) / size)]
            labels[i] = (2, 3)
        else:
            [(px, py)] = input_points[i]
            points[i, 0] = ((px * size + 0.5) / size, (py * size + 0.5) / size)
            labels[i, 0] = 1
    return points, labels


def _rel(q_size, k_size, table):
    coords = (torch.arange(q_size, device=table.device)[:, None]
              - torch.arange(k_size, device=table.device)[None, :] + (k_size - 1))
    return table[coords]


def _encoder_attention(P, pr, name, x, heads):
    b, h, w, dim = x.shape
    d = dim // heads
    qkv = _lin(P, pr, name + ".qkv", x).reshape(b, h * w, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    rh, rw = _rel(h, h, _w(P, name + ".rel_pos_h")), _rel(w, w, _w(P, name + ".rel_pos_w"))
    q_sp = q.reshape(b, heads, h, w, d)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", q_sp, rh)
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", q_sp, rw)
    s = pr.mm(q * d ** -0.5, k.transpose(-1, -2)).reshape(b, heads, h, w, h, w)
    s = s + bias_h[..., :, None] + bias_w[..., None, :]
    p = torch.softmax(s.reshape(b, heads, h * w, h * w), dim=-1)
    out = pr.mm(p, v).transpose(1, 2).reshape(b, h, w, dim)
    return _lin(P, pr, name + ".proj", out)


def _encoder(P, cfg, pr, pixels):
    s = cfg["sam"]
    pe = "vision_encoder."
    x = pr.conv(pixels.permute(0, 3, 1, 2), _w(P, pe + "patch_embed.projection.weight"),
                P[pe + "patch_embed.projection.bias"], stride=s["patch_size"])
    x = x.permute(0, 2, 3, 1) + _w(P, pe + "pos_embed")
    for i in range(s["encoder_layers"]):
        name = f"{pe}layers.{i}"
        win = 0 if i in s["global_attn_layers"] else s["window_size"]
        res = x
        y = _ln(P, name + ".layer_norm1", x, 1e-6)
        if win:
            b, h, w, c = y.shape
            ph, pw = (win - h % win) % win, (win - w % win) % win
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            y = y.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(-1, win, win, c)
        y = _encoder_attention(P, pr, name + ".attn", y, s["encoder_heads"])
        if win:
            y = y.reshape(b, hp // win, wp // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(b, hp, wp, c)[:, :h, :w]
        x = res + y
        y = _ln(P, name + ".layer_norm2", x, 1e-6)
        x = x + _lin(P, pr, name + ".mlp.lin2", F.gelu(_lin(P, pr, name + ".mlp.lin1", y)))
    x = pr.conv(x.permute(0, 3, 1, 2), _w(P, pe + "neck.conv1.weight"))
    x = _ln(P, pe + "neck.layer_norm1", x.permute(0, 2, 3, 1), 1e-6)
    x = pr.conv(x.permute(0, 3, 1, 2), _w(P, pe + "neck.conv2.weight"), padding=1)
    return _ln(P, pe + "neck.layer_norm2", x.permute(0, 2, 3, 1), 1e-6)


def _pe(P, coords):
    x = (2.0 * coords - 1.0) @ _w(P, "prompt_encoder.shared_embedding.positional_embedding")
    x = 2.0 * math.pi * x
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


def _dec_attn(P, pr, name, q, k, v, heads):
    b = q.shape[0]

    def split(t):
        return t.reshape(b, t.shape[1], heads, -1).transpose(1, 2)

    qh = split(_lin(P, pr, name + ".q_proj", q))
    kh = split(_lin(P, pr, name + ".k_proj", k))
    vh = split(_lin(P, pr, name + ".v_proj", v))
    s = pr.mm(qh, kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    out = pr.mm(torch.softmax(s, dim=-1), vh).transpose(1, 2).reshape(b, q.shape[1], -1)
    return _lin(P, pr, name + ".out_proj", out)


def _mlp3(P, pr, name, x):
    x = F.relu(_lin(P, pr, name + ".proj_in", x))
    x = F.relu(_lin(P, pr, name + ".layers.0", x))
    return _lin(P, pr, name + ".proj_out", x)


def sam(P, cfg, pr: Prec, images_u8, points, labels):
    """images_u8 (n, oh, ow, 3) uint8; points (n, 2, 2); labels (n, 2) ->
    (mask logits (n, 3, g*4, g*4), iou (n, 3))."""
    s = cfg["sam"]
    size, g, heads = s["image_size"], s["image_size"] // s["patch_size"], s["decoder_heads"]
    dev = images_u8.device
    x = F.interpolate(images_u8.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False).permute(0, 2, 3, 1)
    mean = torch.tensor(SAM_MEAN, device=dev)
    std = torch.tensor(SAM_STD, device=dev)
    emb = _encoder(P, cfg, pr, pr.q((x - mean) / std))
    emb = emb + _w(P, "prompt_encoder.no_mask_embed.weight")[0]
    b = emb.shape[0]

    pts = torch.as_tensor(points, device=dev, dtype=torch.float32)
    lab = torch.as_tensor(labels, device=dev)
    sparse = _pe(P, pts)
    pad = (lab == -1)[..., None]
    nap = _w(P, "prompt_encoder.not_a_point_embed.weight")[0]
    sparse = torch.where(pad, nap, sparse)
    for i in range(4):
        sparse = torch.where((lab == i)[..., None],
                             sparse + _w(P, f"prompt_encoder.point_embed.{i}.weight")[0], sparse)
    sparse = torch.where(pad, nap, sparse)

    c = (torch.arange(g, device=dev, dtype=torch.float32) + 0.5) / g
    dense_pe = _pe(P, torch.stack(torch.meshgrid(c, c, indexing="xy"), dim=-1))
    md = "mask_decoder."
    out_tokens = torch.cat([_w(P, md + "iou_token.weight"), _w(P, md + "mask_tokens.weight")])
    tokens = torch.cat([out_tokens.expand(b, -1, -1), sparse], dim=1)
    dim = emb.shape[-1]
    image = emb.reshape(b, g * g, dim)
    pe = dense_pe.reshape(1, g * g, dim).expand(image.shape)
    token_pe = tokens
    xt, xi = tokens, image
    for li in range(s["decoder_layers"]):
        n = f"{md}transformer.layers.{li}"
        q = xt if li == 0 else xt + token_pe
        xt = _ln(P, n + ".layer_norm1", xt + _dec_attn(P, pr, n + ".self_attn", q, q, xt, heads),
                 1e-6)
        q, k = xt + token_pe, xi + pe
        xt = _ln(P, n + ".layer_norm2",
                 xt + _dec_attn(P, pr, n + ".cross_attn_token_to_image", q, k, xi, heads), 1e-6)
        h = _lin(P, pr, n + ".mlp.lin2", F.relu(_lin(P, pr, n + ".mlp.lin1", xt)))
        xt = _ln(P, n + ".layer_norm3", xt + h, 1e-6)
        q = xt + token_pe
        xi = _ln(P, n + ".layer_norm4",
                 xi + _dec_attn(P, pr, n + ".cross_attn_image_to_token", k, q, xt, heads), 1e-6)
    t = md + "transformer."
    xt = _ln(P, t + "layer_norm_final_attn",
             xt + _dec_attn(P, pr, t + "final_attn_token_to_image", xt + token_pe, xi + pe, xi,
                            heads), 1e-6)
    n_masks = s["num_multimask"] + 1
    iou_out, mask_out = xt[:, 0], xt[:, 1:1 + n_masks]

    def up(x, name):
        y = pr.conv_t(x.permute(0, 3, 1, 2), _w(P, name + ".weight").flip((-2, -1)),
                      P[name + ".bias"], 2)
        return y.permute(0, 2, 3, 1)

    img = up(xi.reshape(b, g, g, dim), md + "upscale_conv1")
    img = F.gelu(_ln(P, md + "upscale_layer_norm", img, 1e-6))
    img = F.gelu(up(img, md + "upscale_conv2"))
    hyper = torch.stack([_mlp3(P, pr, f"{md}output_hypernetworks_mlps.{i}", mask_out[:, i])
                         for i in range(n_masks)], dim=1)
    masks = torch.einsum("btc,bhwc->bthw", pr.q(hyper), pr.q(img))
    iou = _mlp3(P, pr, md + "iou_prediction_head", iou_out)
    return masks[:, 1:], iou[:, 1:]
