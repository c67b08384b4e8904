"""The reference's host-side plan of a call (`reference/layout.py`) agrees
with the program's on the benchmark's own layouts: prompts, token
positions, guidance tables and boxes, for every mix and several seeds."""

import numpy as np
import pytest

from benchmark import traffic
from benchmark.reference import layout as ref

SEEDS = (0, 7, 2**31 + 12345, 987654321987)
LAYOUT_MIXES = ("lmd.seq", "lmd_plus.batch4")


def _program_plan(spec, method):
    from lmdx_torch.core import boxes as boxlib
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.text.parser import BOX_SCALE, convert_spec

    conv = convert_spec(spec, *BOX_SCALE)
    p = GroundedParams(**({"so_center_box": True} if method == "lmd" else
                          {"so_center_box": False}))
    per_box = [(pr, ph, wd, list(boxlib.get_centered_box(
        bx, horizontal_center_only=p.so_horizontal_center_only,
        vertical_placement=p.so_vertical_placement, floor_padding=p.so_floor_padding))
        if p.so_center_box else list(bx)) for pr, ph, wd, bx in conv.so_prompt_phrase_word_box]
    return per_box, conv


@pytest.mark.parametrize("mix", LAYOUT_MIXES)
def test_plan_and_tables_match_the_program(mix):
    from lmdx_torch.sampling import guidance
    from lmdx_torch.text import tokens

    m = traffic.load(mix)
    tok = tokens.WordTokenizer()
    spec_g = guidance.GuidanceSpec(keys=(("mid", 0, 0, 0), ("up", 1, 0, 0)), use_ref_ca=True)
    res = {"mid_0_0_0": (8, 8), "up_1_0_0": (16, 16)}
    for seed in SEEDS:
        for k in range(len(m["cycle"])):
            for c in traffic.call(m, seed, k):
                spec = c["spec"]
                got_box, conv = _program_plan(spec, m["method"])
                want = ref.plan(spec, m["method"])
                assert [x[:3] for x in got_box] == [x[:3] for x in want["per_box"]]
                for (_, _, _, a), (_, _, _, b) in zip(got_box, want["per_box"]):
                    assert ref.raster(a, 64, 64).tolist() == ref.raster(b, 64, 64).tolist()
                assert conv.overall_prompt == want["overall_prompt"]
                assert [(ph, wd) for ph, wd, _ in conv.overall_phrases_words_bboxes] == [
                    (ph, wd) for ph, wd, _ in want["overall"]]
                for prompt, phrase, word, _ in want["per_box"]:
                    idx = tokens.get_phrase_indices(tok, prompt, [phrase], words=[word])
                    assert (idx.object_positions[0], idx.word_token_indices[0]) == \
                        tuple(ref.positions(prompt, phrase, word))
                phrases = [ph for ph, _, _ in want["overall"]]
                words = [wd for _, wd, _ in want["overall"]]
                idx = tokens.get_phrase_indices(tok, want["overall_prompt"], phrases, words=words)
                objects = [(bs, *ref.positions(want["overall_prompt"], ph, wd))
                           for ph, wd, bs in want["overall"]]
                assert [o[1] for o in objects] == idx.object_positions
                data = guidance.make_guidance_data(
                    [bs for _, _, bs in want["overall"]], idx.object_positions, spec_g, (64, 64),
                    4, word_token_indices=idx.word_token_indices,
                    ref_box_to_obj=[o for o, (_, _, bs) in enumerate(want["overall"])
                                    for _ in bs])
                t = ref.tables(objects, res, True)
                for key, name in zip(spec_g.keys, res):
                    for o in range(len(objects)):
                        assert np.array_equal(data["masks"][key][o] > 0,
                                              t["masks"][name][o].reshape(-1))
                        assert data["kfg"][key][o] == t["kfg"][name][o]
                        assert data["kbg"][key][o] == t["kbg"][name][o]
                nb = len(t["box_word_idx"])
                assert list(data["box_word_idx"][:nb]) == t["box_word_idx"]
                assert np.array_equal(data["box_weight"][:nb], np.float32(t["box_weight"]))
