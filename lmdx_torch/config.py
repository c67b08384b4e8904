"""Model/architecture configurations (port of the JAX package's config.py).

Frozen dataclasses, field for field the same as the JAX side, so that a
configuration names the same network in both packages. Served: SD1.5 (LMD),
SD1.4+GLIGEN (LMD+), SD2.1 base (`--use-sdv2`: LMD and the non-GLIGEN
baselines), the SDXL refiner and the SDXL base (the img2img pass behind the
CLI's `--sdxl`, chosen by LMDX_REFINER_MODEL; neither runs as the stage-2
model) and the tiny CPU-test configs (`tiny-test`, `tiny-sdxl`,
`tiny-sdxl-base`).
"""

from __future__ import annotations

import os
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

# The JAX package's switches of the three opt-in kernels, by field; each is
# on when its variable is exactly "1", as the JAX package reads it.
KERNEL_ENV = {"packed_attention": "LMDX_PACKED_ATTENTION",
              "fused_heads": "LMDX_FUSED_HEADS",
              "fused_group_norm": "LMDX_PALLAS_GROUPNORM"}


def kernel_options_from_env() -> KernelOptions:
    """The `KernelOptions` that the JAX package's variables ask for
    (`KERNEL_ENV`). Only entry points call it (the stage-2 CLI and the
    webui), and hand the result to `load_bundle(kernels=...)`; no module
    below them reads the environment."""
    return KernelOptions(**{field_name: os.environ.get(var, "0") == "1"
                            for field_name, var in KERNEL_ENV.items()})


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    # "quick_gelu" for OpenAI CLIP (SD1.x), "gelu" (exact) for OpenCLIP.
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # SDXL conditions on the penultimate layer's hidden states (clip-skip 2).
    penultimate_hidden: bool = False
    # Project the pooled EOS embedding (CLIP's text_projection); SDXL's
    # pooled conditioning is the projected vector.
    use_text_projection: bool = False


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
    # int (every level) or per-level tuple.
    transformer_layers_per_block: int | tuple[int, ...] = 1
    norm_num_groups: int = 32
    # SDXL "text_time" conditioning: the pooled text embedding and the
    # Fourier-embedded micro-conditioning ids, projected into the time
    # embedding. None for SD1.x.
    addition_embed_type: str | None = None
    addition_time_embed_dim: int = 256
    # pooled-text dim + addition_time_embed_dim * number of time ids
    projection_class_embeddings_input_dim: int = 2816
    # Linear (not 1x1 conv) projections in and out of each transformer.
    use_linear_projection: bool = False
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    use_gligen: bool = False
    gligen_fourier_freqs: int = 8
    gligen_max_objs: int = 30

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def head_dim(self, channels: int, level: int) -> int:
        return channels // self.num_attention_heads[level]

    def transformer_depth(self, level: int) -> int:
        if isinstance(self.transformer_layers_per_block, int):
            return self.transformer_layers_per_block
        return self.transformer_layers_per_block[level]


@dataclass(frozen=True)
class SDConfig:
    key: str = "gligen/diffusers-generation-text-box"
    unet: UNetConfig = field(default_factory=UNetConfig)
    clip: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    # The SDXL base's second tower (OpenCLIP bigG, in text_encoder_2/): the
    # UNet context is the feature concat of both towers' hidden states, the
    # pooled vector this tower's projected embedding. None for one tower.
    clip2: CLIPTextConfig | None = None
    # Checkpoint subdirectory holding the (first) text tower's weights.
    text_encoder_dir: str = "text_encoder"
    vae: VAEConfig = field(default_factory=VAEConfig)
    height: int = 512
    width: int = 512
    dtype: str = "bfloat16"
    # The integrator the checkpoint's scheduler config names: "ddim" for the
    # SD bundles and the SDXL base, "euler" (EulerDiscrete) for the SDXL
    # refiner.
    default_scheduler: str = "ddim"

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

    @property
    def pooled_dim(self) -> int:
        """Width of the pooled text embedding that text_time takes (the SDXL
        base takes it from its second tower)."""
        return (self.clip2 or self.clip).hidden_size

    @property
    def context_dim(self) -> int:
        """Width of the UNet's cross-attention context (two towers: the
        concat of both widths)."""
        return self.clip.hidden_size + (self.clip2.hidden_size if self.clip2 else 0)


def sd15() -> SDConfig:
    """SD v1.5 (training-free LMD's base model)."""
    return SDConfig(key="runwayml/stable-diffusion-v1-5")


def sd14_gligen() -> SDConfig:
    """SD v1.4 with GLIGEN grounding adapters (LMD+'s base model)."""
    return SDConfig(key="gligen/diffusers-generation-text-box",
                    unet=UNetConfig(use_gligen=True))


def sd21_base() -> SDConfig:
    """SD v2.1 base (stabilityai/stable-diffusion-2-1-base, the reference's
    `--use-sdv2`): the SD1.x UNet with linear projections, 5/10/20/20 heads
    (head dim 64 at every level) and 1024-wide cross-attention, conditioned
    on the last hidden state of OpenCLIP ViT-H (23 layers, 1024 wide, 16
    heads, exact GELU), 512x512, DDIM."""
    return SDConfig(
        key="stabilityai/stable-diffusion-2-1-base",
        unet=UNetConfig(cross_attention_dim=1024, num_attention_heads=(5, 10, 20, 20),
                        use_linear_projection=True),
        clip=CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_layers=23,
                            num_heads=16, hidden_act="gelu"),
    )


def sdxl_refiner() -> SDConfig:
    """The SDXL refiner (stabilityai/stable-diffusion-xl-refiner-1.0): one
    OpenCLIP bigG tower (penultimate hidden states, projected pooled
    embedding) shipped as text_encoder_2/, a 4-level UNet with 4 transformer
    blocks at each attention level (none at the first and last), head dim 64,
    linear projections, text_time conditioning on 5 ids (size, crop,
    aesthetic score), 1024x1024, EulerDiscrete."""
    return SDConfig(
        key="stabilityai/stable-diffusion-xl-refiner-1.0",
        unet=UNetConfig(
            block_out_channels=(384, 768, 1536, 1536),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                              "CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                            "CrossAttnUpBlock2D", "UpBlock2D"),
            cross_attention_dim=1280,
            num_attention_heads=(6, 12, 24, 24),
            transformer_layers_per_block=4,
            use_linear_projection=True,
            addition_embed_type="text_time",
            projection_class_embeddings_input_dim=2560,  # 1280 + 256 * 5
        ),
        clip=CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_layers=32,
                            num_heads=20, hidden_act="gelu", penultimate_hidden=True,
                            use_text_projection=True),
        text_encoder_dir="text_encoder_2",
        height=1024,
        width=1024,
        default_scheduler="euler",
    )


def sdxl_base() -> SDConfig:
    """The SDXL base (stabilityai/stable-diffusion-xl-base-1.0): a 3-level
    UNet (transformer depths 1, 2, 10 at the levels without, with 4096 and
    with 1024 tokens at 1024x1024; head dim 64), linear projections, text_time
    on 6 ids (size, crop, target size), conditioned on the feature concat of
    two towers' penultimate hidden states: CLIP ViT-L (768, quick GELU) and
    OpenCLIP bigG (1280, exact GELU; its projected pooled embedding is the
    pooled vector): a 2048-wide context. 1024x1024, DDIM."""
    return SDConfig(
        key="stabilityai/stable-diffusion-xl-base-1.0",
        unet=UNetConfig(
            block_out_channels=(320, 640, 1280),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            cross_attention_dim=2048,
            num_attention_heads=(5, 10, 20),
            transformer_layers_per_block=(1, 2, 10),
            use_linear_projection=True,
            addition_embed_type="text_time",
            projection_class_embeddings_input_dim=2816,  # 1280 + 256 * 6
        ),
        clip=CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_layers=12,
                            num_heads=12, hidden_act="quick_gelu", penultimate_hidden=True),
        clip2=CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_layers=32,
                             num_heads=20, hidden_act="gelu", penultimate_hidden=True,
                             use_text_projection=True),
        height=1024,
        width=1024,
    )


def tiny_sdxl() -> SDConfig:
    """Miniature SDXL-class config for CPU tests (per-level transformer
    depth, text_time, linear projections; same as the JAX side)."""
    return SDConfig(
        key="tiny-sdxl",
        unet=UNetConfig(
            block_out_channels=(32, 64),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            layers_per_block=1,
            cross_attention_dim=32,
            num_attention_heads=(2, 2),
            transformer_layers_per_block=(1, 2),
            norm_num_groups=8,
            use_linear_projection=True,
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=32 + 8 * 5,
        ),
        clip=CLIPTextConfig(vocab_size=1024, hidden_size=32, intermediate_size=64,
                            num_layers=2, num_heads=2, penultimate_hidden=True,
                            use_text_projection=True),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                      norm_num_groups=8),
        height=32,
        width=32,
        dtype="float32",
    )


def tiny_sdxl_base() -> SDConfig:
    """Miniature SDXL-base config for CPU tests: two towers (16 and 32 wide)
    whose concat (48) is the context, pooled from the second tower's
    projection (same as the JAX side)."""
    return SDConfig(
        key="tiny-sdxl-base",
        unet=UNetConfig(
            block_out_channels=(32, 64),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            layers_per_block=1,
            cross_attention_dim=48,  # 16 (clip) + 32 (clip2)
            num_attention_heads=(2, 2),
            transformer_layers_per_block=(1, 2),
            norm_num_groups=8,
            use_linear_projection=True,
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=32 + 8 * 6,
        ),
        clip=CLIPTextConfig(vocab_size=1024, hidden_size=16, intermediate_size=32,
                            num_layers=2, num_heads=2, penultimate_hidden=True),
        clip2=CLIPTextConfig(vocab_size=1024, hidden_size=32, intermediate_size=64,
                             num_layers=2, num_heads=2, hidden_act="gelu",
                             penultimate_hidden=True, use_text_projection=True),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                      norm_num_groups=8),
        height=32,
        width=32,
        dtype="float32",
    )


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
    "stabilityai/stable-diffusion-2-1-base": sd21_base,
    "stabilityai/stable-diffusion-xl-refiner-1.0": sdxl_refiner,
    "stabilityai/stable-diffusion-xl-base-1.0": sdxl_base,
    "tiny-test": tiny_test,
    "tiny-sdxl": tiny_sdxl,
    "tiny-sdxl-base": tiny_sdxl_base,
}
