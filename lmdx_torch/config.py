"""Model/architecture configurations (port of the JAX package's config.py).

Frozen dataclasses, field for field the same as the JAX side, so that a
configuration names the same network in both packages. Served: SD1.5 (LMD),
SD1.4+GLIGEN (LMD+) and the tiny CPU-test config.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class KernelOptions:
    """Which opt-in kernels the UNet runs (the JAX package chooses them with
    LMDX_PACKED_ATTENTION, LMDX_FUSED_HEADS and LMDX_PALLAS_GROUPNORM; the
    port takes them as a constructor argument and reads no environment).

    packed_attention: the per-head flash forward takes heads in groups
        (`flash_attention_fwd_packed`).
    fused_heads: untapped attention layers run on the projection layout
        `(B, L, heads * head_dim)` where `fusedheads_supported` allows.
    fused_group_norm: the UNet's GroupNorms take their statistics from the
        `pair_stats` kernel (`FusedGroupNorm`).
    All off is the default path."""

    packed_attention: bool = False
    fused_heads: bool = False
    fused_group_norm: bool = False


ALL_KERNELS = KernelOptions(packed_attention=True, fused_heads=True,
                            fused_group_norm=True)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # Heads per resolution level (SD1.x: 8 heads, head_dim = C / 8).
    num_attention_heads: tuple[int, ...] = (8, 8, 8, 8)
    transformer_layers_per_block: int = 1
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    use_gligen: bool = False
    gligen_fourier_freqs: int = 8
    gligen_max_objs: int = 30

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclass(frozen=True)
class SDConfig:
    key: str = "gligen/diffusers-generation-text-box"
    unet: UNetConfig = field(default_factory=UNetConfig)
    clip: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    # Checkpoint subdirectory holding the text tower's weights.
    text_encoder_dir: str = "text_encoder"
    vae: VAEConfig = field(default_factory=VAEConfig)
    height: int = 512
    width: int = 512
    dtype: str = "bfloat16"

    @property
    def vae_scale(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)

    @property
    def latent_height(self) -> int:
        return self.height // self.vae_scale

    @property
    def latent_width(self) -> int:
        return self.width // self.vae_scale

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def sd15() -> SDConfig:
    """SD v1.5 (training-free LMD's base model)."""
    return SDConfig(key="runwayml/stable-diffusion-v1-5")


def sd14_gligen() -> SDConfig:
    """SD v1.4 with GLIGEN grounding adapters (LMD+'s base model)."""
    return SDConfig(key="gligen/diffusers-generation-text-box",
                    unet=UNetConfig(use_gligen=True))


def tiny_test() -> SDConfig:
    """Miniature GLIGEN-capable config for CPU tests (same as the JAX side)."""
    return SDConfig(
        key="tiny-test",
        unet=UNetConfig(
            block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1,
            cross_attention_dim=32,
            num_attention_heads=(2, 2),
            norm_num_groups=8,
            use_gligen=True,
            gligen_max_objs=8,
        ),
        clip=CLIPTextConfig(vocab_size=1024, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                      norm_num_groups=8),
        height=32,
        width=32,
        dtype="float32",
    )


SD_CONFIGS = {
    "runwayml/stable-diffusion-v1-5": sd15,
    "gligen/diffusers-generation-text-box": sd14_gligen,
    "tiny-test": tiny_test,
}
