"""The port's LMD+ slice with the three opt-in kernels switched on
(`KernelOptions(packed_attention, fused_heads, fused_group_norm)`): the
tiny-test UNet and `run_lmd_plus_batch` against the JAX package, exactly as
tests/test_torch_slice.py holds the default path (same weights: converted
JAX parameters; same noise: LMDX_NOISE_BACKEND=torch; two-box layouts).

The JAX UNet never wires its FusedGroupNorm in, so the reference is the JAX
UNet on plain GroupNorm, which computes the same function. On the CPU every
wrapper computes its plain version; the tests check that the opt-in wrappers
were the ones called.

Tolerance: the UNet 1e-4 abs+rel (as tests/test_torch_modules.py: f32 sums in
other orders over a dozen layers; the fused norm's var = m2 - mean^2 is part
of that); the slice as tests/test_torch_slice.py: frozen masks identical,
images within 2 uint8 levels. With the options off the bundle computes the
default path bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.methods.batch import run_lmd_plus_batch as jax_run
from lmdx.nn.unet import apply_unet as japply_unet
from lmdx.runtime import models as jmodels
from lmdx.sampling import guidance as jguid
from lmdx_torch import config as tconfig
from lmdx_torch.methods.batch import run_lmd_plus_batch as torch_run
from lmdx_torch.nn.attention import CrossAttention, GroupNorm
from lmdx_torch.nn.kernels import flash_attention as fa
from lmdx_torch.nn.kernels import group_norm as gn
from lmdx_torch.nn.unet import apply_unet as tapply_unet
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.sampling import guidance as tguid

REPO = Path(__file__).resolve().parents[1]

SPECS = [
    {"prompt": "A realistic scene with a red cube and a blue ball",
     "gen_boxes": [("a red cube", (50, 300, 120, 120)),
                   ("a blue ball", (300, 280, 100, 100))],
     "bg_prompt": "A realistic scene", "extra_neg_prompt": ""},
    {"prompt": "A park with a green tree and a red bench",
     "gen_boxes": [("a green tree", (200, 100, 150, 250)),
                   ("a red bench", (20, 350, 160, 100))],
     "bg_prompt": "A park", "extra_neg_prompt": "people"},
]
OVERRIDES = dict(max_iter=1, overall_max_iter=1, overall_max_index_step=2)
WRAPPERS = ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
            (fa, "flash_attention_fwd_packed"), (fa, "flash_attention_fwd_fusedheads"),
            (gn, "pair_stats"))


@pytest.fixture(scope="module")
def bundles():
    jb = jmodels.load_bundle("tiny-test", seed=0)
    params = jax.tree_util.tree_map(np.asarray, jb.params)
    state = convert.from_jax_params(params, tconfig.tiny_test())
    on = tmodels.build_bundle(tconfig.tiny_test(), state, device="cpu",
                              kernels=tconfig.ALL_KERNELS)
    off = tmodels.build_bundle(tconfig.tiny_test(), state, device="cpu")
    return jb, on, off


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of every kernel wrapper (on the CPU each computes its
    plain version)."""
    counts = {name: 0 for _, name in WRAPPERS}
    for module, name in WRAPPERS:
        def spy(*a, _name=name, _fn=getattr(module, name), **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, spy)
    return counts


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_optin_unet_forward_and_early_exit_taps_match_jax(bundles, calls):
    jb, on, _ = bundles
    rng = np.random.default_rng(4)
    lat, ctx = _rand(rng, 2, 16, 16, 4), _rand(rng, 2, 77, 32)
    objs = _rand(rng, 2, 8, 32)
    want, _ = japply_unet(jb.unet, jb.params["unet"], jnp.asarray(lat), 501,
                          jnp.asarray(ctx), objs=jnp.asarray(objs))
    got, _ = tapply_unet(on.unet, torch.tensor(lat), 501, torch.tensor(ctx),
                         objs=torch.tensor(objs))
    _close(got, want)
    # tiny-test: 4 transformer blocks (down 1, mid 1, up 2) x (self, fuser,
    # cross), every one inside the size rule; 8 resnets (down 1 + 1, mid 2,
    # up 2 + 2) x 2 norms, 4 transformer norms, conv_norm_out.
    assert calls == {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                     "flash_attention_fwd_packed": 0,
                     "flash_attention_fwd_fusedheads": 12, "pair_stats": 21}

    keys = tguid.default_guidance_keys(on.config.unet)
    _, jtaps = japply_unet(jb.unet, jb.params["unet"], jnp.asarray(lat), 501,
                           jnp.asarray(ctx), objs=jnp.asarray(objs),
                           taps=jguid.GuidanceSpec(keys=keys).tap_spec,
                           stop_after_taps=True)
    eps, ttaps = tapply_unet(on.unet, torch.tensor(lat), 501, torch.tensor(ctx),
                             objs=torch.tensor(objs),
                             taps=tguid.GuidanceSpec(keys=keys).tap_spec,
                             stop_after_taps=True)
    assert eps is None and set(ttaps) == set(jtaps) == set(keys)
    for k in keys:
        _close(ttaps[k], jtaps[k])


def test_optin_latent_gradient_matches_the_default_path(bundles, calls):
    """The guidance gradient (taps -> latents) through the fused norms' and
    the fused-heads attention's backward against autograd through the default
    modules."""
    _, on, off = bundles
    rng = np.random.default_rng(6)
    lat, ctx = _rand(rng, 2, 16, 16, 4), _rand(rng, 2, 77, 32)
    objs = _rand(rng, 2, 8, 32)
    spec = tguid.GuidanceSpec(keys=tguid.default_guidance_keys(on.config.unet)).tap_spec
    grads = []
    for bundle in (on, off):
        x = torch.tensor(lat, requires_grad=True)
        taps = tapply_unet(bundle.unet, x, 501, torch.tensor(ctx), objs=torch.tensor(objs),
                           taps=spec, stop_after_taps=True)[1]
        loss = sum((t * t).sum() for t in taps.values())
        grads.append(torch.autograd.grad(loss, x)[0])
        if bundle is on:
            assert calls["flash_attention_bwd"] > 0 and calls["pair_stats"] > 0
            assert calls["flash_attention_fwd"] == 0
    scale = grads[1].abs().max().item()
    assert scale > 0
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-4,
                               atol=1e-4 * scale)


def test_optin_run_lmd_plus_batch_matches_jax(monkeypatch, bundles, calls):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, on, _ = bundles
    kw = dict(OVERRIDES, num_inference_steps=6)
    want = jax_run(SPECS, jb, bg_seeds=[1, 2], **kw)
    got = torch_run(SPECS, on, bg_seeds=[1, 2], **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.image.dtype == np.uint8 and g.image.shape == w.image.shape
        np.testing.assert_array_equal(g.aux["frozen_mask"], w.aux["frozen_mask"])
        np.testing.assert_array_equal(g.aux["foreground_indices"],
                                      w.aux["foreground_indices"])
        diff = np.abs(g.image.astype(np.int32) - w.image.astype(np.int32))
        assert diff.max() <= 2, diff.max()
    assert got[0].aux["frozen_mask"].sum() > 0
    assert calls["flash_attention_fwd_fusedheads"] > 0 and calls["pair_stats"] > 0
    assert calls["flash_attention_bwd"] > 0 and calls["flash_attention_fwd"] == 0


def test_options_off_is_the_default_path(bundles, calls):
    """`kernels=None` and `KernelOptions()` build the same modules as before
    the options existed (plain GroupNorm, no option set on any attention),
    call none of the opt-in wrappers, and compute the same bits."""
    jb, _, off = bundles
    params = jax.tree_util.tree_map(np.asarray, jb.params)
    explicit = tmodels.build_bundle(
        tconfig.tiny_test(), convert.from_jax_params(params, tconfig.tiny_test()),
        device="cpu", kernels=tconfig.KernelOptions())
    rng = np.random.default_rng(7)
    lat, ctx = _rand(rng, 2, 16, 16, 4), _rand(rng, 2, 77, 32)
    objs = _rand(rng, 2, 8, 32)
    outs = [tapply_unet(b.unet, torch.tensor(lat), 501, torch.tensor(ctx),
                        objs=torch.tensor(objs))[0] for b in (off, explicit)]
    assert torch.equal(outs[0], outs[1])
    assert calls["flash_attention_fwd_packed"] == calls["flash_attention_fwd_fusedheads"] == 0
    assert calls["pair_stats"] == 0 and calls["flash_attention_fwd"] > 0
    for bundle in (off, explicit):
        norms = [m for n, m in bundle.unet.named_modules() if "norm" in n.rsplit(".", 1)[-1]
                 and not isinstance(m, torch.nn.LayerNorm)]
        assert norms and all(type(m) is GroupNorm for m in norms)
        attns = [m for m in bundle.unet.modules() if isinstance(m, CrossAttention)]
        assert attns and all(m.options == tconfig.KernelOptions() for m in attns)


def test_state_dict_is_the_same_under_every_option(bundles):
    _, on, off = bundles
    assert list(on.unet.state_dict()) == list(off.unet.state_dict())
    for (name, a), b in zip(on.unet.state_dict().items(), off.unet.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_port_kernel_modules_import_no_jax_and_read_no_kernel_switch():
    code = ("import sys\n"
            "sys.modules['jax'] = None\nsys.modules['flax'] = None\n"
            "sys.modules['lmdx'] = None\n"
            "import lmdx_torch.nn.kernels.group_norm, lmdx_torch.nn.kernels.flash_attention\n"
            "import lmdx_torch.nn.unet, lmdx_torch.runtime.models, lmdx_torch.config\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path in (REPO / "lmdx_torch").rglob("*.py"):
        text = path.read_text()
        for switch in ("LMDX_PACKED_ATTENTION", "LMDX_FUSED_HEADS", "LMDX_PALLAS_GROUPNORM"):
            assert f'"{switch}"' not in text and f"'{switch}'" not in text, path
        if "kernels" in path.parts and path.name != "build.py":
            assert "os.environ" not in text, path
