"""The port's mesh and serving helpers (`lmdx_torch/dist/{mesh,serve}.py`)
against the JAX package's (`lmdx/dist/`), in this process.

- `parse_mesh_arg`, `arrange_devices` and their refusals on the fake
  topologies of `tests/test_dist.py` (the same layouts and messages); the
  no-coordinator no-op; `shard_leading_axis`'s identity, its dp slices and
  its once-per-signature warning; `make_mesh` in one process (a 1x1 mesh
  over a one-rank gloo group that `close` ends); the CLI's count of local
  ranks.
- `param_spec` at tp 2 against the JAX `param_spec` over the tiny-test
  config and the full SD1.4+GLIGEN and SDXL base trees (shapes only, from
  `jax.eval_shape`, mapped to the port's names by `runtime/convert.py`):
  every JAX leaf has a port parameter of the same kind, except the
  whole-kept layers, which the test names: the VAE's single-head attention
  and PositionNet's `linears.0` (no row-split partner). SD2.1's 5-head
  level at tp 2 is whole as well (the port's modules on `meta`).
"""

import re
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lmdx.dist import mesh as jmesh
from lmdx.dist import serve as jserve
from lmdx.runtime import models as jmodels
from lmdx_torch import config as tconfig
from lmdx_torch.cli import generate as tgen
from lmdx_torch.dist import mesh as meshlib
from lmdx_torch.dist import serve
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels


@pytest.mark.parametrize("arg", ["auto", "", "dp=4", "dp=4,tp=2", "tp=2", "pp=2", "dp=x",
                                 "dp=2,tp"])
def test_parse_mesh_arg_matches_jax(arg):
    try:
        want = jserve.parse_mesh_arg(arg)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            serve.parse_mesh_arg(arg)
        return
    assert serve.parse_mesh_arg(arg) == want


class _Dev:
    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index


def _cluster(n_proc, per_proc):
    return [_Dev(id=p + n_proc * i, process_index=p)
            for p in range(n_proc) for i in range(per_proc)]


@pytest.mark.parametrize("n_proc,per,dp,tp", [(4, 8, 16, 2), (4, 8, 4, 8), (2, 4, 8, 1),
                                              (2, 4, 2, 4), (1, 8, 4, 2)])
def test_arrange_devices_matches_jax(n_proc, per, dp, tp):
    devs = _cluster(n_proc, per)
    ids = np.vectorize(lambda d: d.id)
    np.testing.assert_array_equal(ids(meshlib.arrange_devices(devs, dp, tp)),
                                  ids(jmesh.arrange_devices(devs, dp, tp)))


@pytest.mark.parametrize("extra,dp,tp", [(False, 1, 8), (False, 2, 3), (False, 3, 2),
                                         (True, 2, 4)],
                         ids=["tp_across_hosts", "tp_not_dividing", "wrong_dp", "uneven"])
def test_arrange_devices_refuses_as_jax(extra, dp, tp):
    devs = _cluster(2, 4) + ([_Dev(id=99, process_index=0)] if extra else [])
    with pytest.raises(ValueError) as want:
        jmesh.arrange_devices(devs, dp, tp)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        meshlib.arrange_devices(devs, dp, tp)


def test_initialize_multihost_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("LMDX_COORDINATOR", raising=False)
    assert meshlib.initialize_multihost() is False
    assert not dist.is_initialized()


def _stand_in(dp, tp, rank):
    """A Mesh as `shard_leading_axis` reads it (no process group)."""
    return meshlib.Mesh(ranks=np.arange(dp * tp).reshape(dp, tp), rank=rank,
                        device=torch.device("cpu"), dp_group=None, tp_group=None,
                        owns_world=False)


def test_shard_leading_axis_identity_without_mesh():
    x = np.ones((4, 3))
    assert serve.shard_leading_axis(x) is x
    assert serve.shard_leading_axis(x, mesh=_stand_in(1, 2, 1)) is x


def test_shard_leading_axis_takes_the_dp_rows_share():
    mesh = _stand_in(4, 2, 5)  # row 2 of 4
    assert mesh.dp_index == 2 and mesh.tp_index == 1
    x = np.arange(16).reshape(8, 2)
    np.testing.assert_array_equal(serve.shard_leading_axis(x, mesh=mesh), x[4:6])
    assert serve.shard_leading_axis(list(range(8)), mesh=mesh) == [4, 5]
    t = torch.arange(24).reshape(2, 12)
    assert torch.equal(serve.shard_leading_axis(t, mesh=mesh, axis=1), t[:, 6:9])


def test_shard_leading_axis_warns_on_silent_replication():
    mesh = _stand_in(4, 2, 0)
    serve._WARNED_REPLICATED.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x = np.ones((3, 2))
        assert serve.shard_leading_axis(x, mesh=mesh) is x
        assert [w for w in caught if "replicating" in str(w.message)]
        n = len(caught)
        serve.shard_leading_axis(np.ones((3, 2)), mesh=mesh)
        assert len(caught) == n
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert serve.shard_leading_axis(np.ones((8, 2)), mesh=mesh).shape == (2, 2)
        assert not caught


def test_batch_layouts_match_jax():
    assert meshlib.batch_spec(4) == tuple(jmesh.batch_spec(4))
    assert meshlib.batch_spec(2) == tuple(jmesh.batch_spec(2))
    mesh = _stand_in(2, 2, 3)  # row 1 of 2
    batch = {"x0": torch.arange(8.0).reshape(4, 2), "t": torch.tensor(7),
             "odd": np.arange(3), "nested": [np.ones((2, 1))]}
    got = meshlib.shard_batch(batch, mesh)
    assert torch.equal(got["x0"], batch["x0"][2:])
    assert torch.equal(got["t"], batch["t"])                      # a scalar stays whole
    assert torch.equal(got["odd"], torch.arange(3))               # 3 does not divide dp 2
    assert torch.equal(got["nested"][0], torch.ones((1, 1)))
    whole = meshlib.replicate(batch, mesh)
    assert torch.equal(whole["x0"], batch["x0"]) and whole["nested"][0].shape == (2, 1)


def test_make_mesh_in_one_process_is_one_rank():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="dp\\*tp"):
        meshlib.make_mesh(dp=2, device="cpu")
    assert not dist.is_initialized()
    mesh = meshlib.make_mesh(device="cpu")
    try:
        assert mesh.shape == {"dp": 1, "tp": 1} and mesh.owns_world
        assert (mesh.dp_members, mesh.tp_members) == ([0], [0])
        x = torch.arange(6.0)
        assert torch.equal(meshlib.all_reduce(x, mesh.tp_group), x)
        assert meshlib.from_rank0("rank 0's") == "rank 0's" and meshlib.is_writer()
    finally:
        mesh.close()
    assert not dist.is_initialized()


@pytest.mark.parametrize("kwargs,n_local,want", [({}, 1, 1), ({}, 8, 8), ({"dp": 2}, 1, 2),
                                                 ({"dp": 4}, 8, 8), ({"tp": 2}, 8, 8),
                                                 ({"dp": 2, "tp": 2}, 1, 4)])
def test_cli_local_world(kwargs, n_local, want):
    assert tgen.local_world(kwargs, n_local) == want


def _jax_kinds(tree) -> dict:
    """{port name: kind} of a JAX parameter tree under the JAX `param_spec`."""
    spec = jmesh.param_spec(tree)
    out = {}
    for path, leaf in convert._flatten(tree):
        s = spec
        for k in path:
            s = s[k]
        dummy = np.zeros((1,) * len(leaf.shape), np.float32)
        name = convert._leaf(path, dummy)[0]
        if "tp" not in tuple(s):
            out[name] = "whole"
        elif path[-1] == "kernel" and tuple(s)[0] == "tp":
            out[name] = "row"
        else:
            out[name] = "column"
    return out


def _kept(key):
    """The names whose JAX kind the port keeps whole at tp 2, per component."""
    cfg = jmodels.SD_CONFIGS[key]()
    shapes = jax.eval_shape(lambda: jmodels.init_random_params(cfg, seed=0))
    with torch.device("meta"):
        parts = tmodels.build_modules(tconfig.SD_CONFIGS[key]())
    trees = {"unet": shapes["unet"], "text": shapes["text"], "text2": shapes.get("text2"),
             "position_net": shapes.get("position_net"),
             "vae": {k: shapes["vae"][k] for k in ("encoder", "quant_conv", "decoder",
                                                    "post_quant_conv")}}
    kept = {}
    for part, tree in trees.items():
        if tree is None:
            assert parts[part] is None
            continue
        want = _jax_kinds(tree)
        got = meshlib.param_spec(parts[part], 2)
        assert set(got) == set(want), part
        diff = {n for n in want if got[n] != want[n]}
        assert all(got[n] == "whole" for n in diff), part
        assert any(k != "whole" for k in got.values()) or part in ("vae", "position_net")
        kept[part] = diff
    return kept


VAE_ATTENTION = {f"{side}.mid_block.attentions.0.{leaf}"
                 for side in ("encoder", "decoder")
                 for leaf in ("to_q.weight", "to_q.bias", "to_k.weight", "to_k.bias",
                              "to_v.weight", "to_v.bias", "to_out.0.weight")}
POSITION_NET = {"linears.0.weight", "linears.0.bias"}


@pytest.mark.parametrize("key", ["tiny-test", "gligen/diffusers-generation-text-box",
                                 "stabilityai/stable-diffusion-xl-base-1.0"])
def test_param_spec_matches_jax_but_the_whole_kept(key):
    kept = _kept(key)
    assert kept.pop("vae") == VAE_ATTENTION
    assert kept.pop("position_net", POSITION_NET) == POSITION_NET
    assert all(not names for names in kept.values()), kept


def test_param_spec_keeps_heads_tp_does_not_divide_whole():
    with torch.device("meta"):
        unet = tmodels.build_modules(
            tconfig.SD_CONFIGS["stabilityai/stable-diffusion-2-1-base"]())["unet"]
    spec = meshlib.param_spec(unet, 2)
    five = "down_blocks.0.attentions.0.transformer_blocks.0"   # 5 heads
    ten = "down_blocks.1.attentions.0.transformer_blocks.0"    # 10 heads
    assert spec[f"{five}.attn1.to_q.weight"] == "whole"
    assert spec[f"{five}.attn1.to_out.0.weight"] == "whole"
    assert spec[f"{five}.ff.net.0.proj.weight"] == "column"   # its MLP still splits
    assert spec[f"{ten}.attn1.to_q.weight"] == "column"
    assert spec[f"{ten}.attn1.to_out.0.weight"] == "row"
    assert spec[f"{ten}.attn1.to_out.0.bias"] == "whole"
