"""The yardstick's arithmetic against hand counts: an attention call's
least time, and the FLOP counts of the plain reference at small shapes."""

import pytest
import torch

from benchmark import flops
from benchmark.reference import sd
from benchmark.reference.prec import Prec


def test_attention_bound_forward_by_operations():
    # B 2, 8 heads, 4096 x 4096, d 40, bf16: 4 B h L L d operations.
    ops = 4 * 2 * 8 * 4096 * 4096 * 40
    nbytes = 2 * 2 * 8 * 40 * (2 * 4096 + 2 * 4096) + 4 * 2 * 8 * 4096
    got = flops.attention_bound_s("fwd", 2, 8, 4096, 4096, 40, 2, flops.PEAK_BF16_FLOPS)
    assert got == pytest.approx(max(ops / 989e12, nbytes / 3.35e12))
    assert got == pytest.approx(ops / 989e12)


def test_attention_bound_backward_and_bytes():
    ops = 10 * 1 * 1 * 64 * 77 * 8
    nbytes = 4 * 8 * (3 * 64 + 2 * 77) + 4 * 64 + 4 * 8 * (64 + 2 * 77)
    got = flops.attention_bound_s("bwd", 1, 1, 64, 77, 8, 4, flops.PEAK_TF32X3_FLOPS)
    assert got == pytest.approx(max(ops / (495e12 / 3), nbytes / 3.35e12))
    assert got == pytest.approx(nbytes / 3.35e12)        # tiny shapes are bound by bytes


def test_peaks_by_dtype():
    assert flops.peak_flops("bfloat16") == 989e12
    assert flops.peak_flops("float32") == pytest.approx(165e12)


def test_flop_counter_matches_hand_count_of_a_linear_and_a_conv():
    P = {"w.weight": torch.empty(64, 32), "w.bias": torch.empty(64),
         "c.weight": torch.empty(16, 8, 3, 3), "c.bias": torch.empty(16)}
    P = {k: v.to("meta") for k, v in P.items()}
    x = torch.empty(5, 32, device="meta")
    assert flops._count(lambda: sd._lin(P, Prec(), "w", x)) == 2 * 5 * 32 * 64
    img = torch.empty(2, 8, 10, 10, device="meta")
    assert (flops._count(lambda: sd._conv(P, Prec(), "c", img, padding=1))
            == 2 * 2 * 16 * 8 * 9 * 10 * 10)


def test_attention_flops_of_the_reference():
    q = torch.empty(2, 10, 4 * 8, device="meta")
    k = torch.empty(2, 7, 4 * 8, device="meta")
    got = flops._count(lambda: sd.attention(Prec(), q, k, k, 4))
    assert got == 4 * 2 * 4 * 10 * 7 * 8


def test_unet_flops_grow_with_batch_and_guidance_adds_a_backward():
    import json
    from benchmark.tests.conftest import DATA

    cfg = json.loads((DATA / "tiny.json").read_text())
    from benchmark.generate import make_weights

    state, _, _ = make_weights(cfg, 1, torch.device("cpu"))
    shapes = {k: tuple(v.shape) for k, v in state["unet"].items()}
    one = flops.unet_flops(cfg, shapes, 1, True)
    assert flops.unet_flops(cfg, shapes, 3, True) == 3 * one
    taps = ("mid_0_0_0", "up_1_0_0", "up_1_1_0")
    guided = flops.unet_flops(cfg, shapes, 1, True, guided=True, tap_names=taps)
    assert guided > one
