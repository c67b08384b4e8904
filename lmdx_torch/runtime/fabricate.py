"""Random checkpoints with the key names and shapes of the published ones.

    python -m lmdx_torch.runtime.fabricate --root DIR [--models KEY ...] [--sam]
                                           [--owlvit] [--sdxl-refiner]
                                           [--dtype float16|float32]

Writes `<root>/<model--key>/{unet,text_encoder,vae}/` (diffusers file names)
for each SD model key (the SDXL refiner's tower in `text_encoder_2/`:
`--sdxl-refiner` adds `stabilityai/stable-diffusion-xl-refiner-1.0`, 3.038B
values, 6.08 GB in fp16; `--models` also takes
`stabilityai/stable-diffusion-2-1-base`, 1.290B values, and
`stabilityai/stable-diffusion-xl-base-1.0`, 3.469B values with both towers,
`text_encoder/` and `text_encoder_2/`), with `--sam`, `<root>/facebook--sam-vit-base/` and,
with `--owlvit`, `<root>/google--owlvit-base-patch32/` (153.2M values, 0.31
GB in fp16), in the safetensors format, with exactly the keys and shapes of the manifests
(`runtime/manifests/`). Values: norm weights 1 (a zero scale would zero every
activation), everything else N(0, 0.02): finite numbers that exercise the
load at production shapes, not a model. Each tensor draws from its own numpy
generator, seeded with the CRC-32 of `<model key>/<component>/<tensor name>`,
so the bytes are the same in every process (Python's `hash` is salted per
process) and the tensors are drawn on all cores at once. `--dtype float16`
halves the bytes, as the fp16 variants published for these models do.

The directories load with `runtime.models.load_bundle(key, <root>/<model--key>)`
(set LMDX_ALLOW_WORD_TOKENIZER=1: a fabricated checkpoint has no tokenizer)
and `runtime.models.load_segmenter(<root>/facebook--sam-vit-base)`; the
OWL-ViT directory with `eval.owl_vit.OwlViTDetector.from_checkpoint`.
"""

from __future__ import annotations

import argparse
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import convert, safetensors_io

# Component subdirectory -> the weight file name `convert._load_state_dict`
# probes first for it.
FILENAMES = {"unet": "diffusion_pytorch_model.safetensors",
             "vae": "diffusion_pytorch_model.safetensors",
             "text_encoder": "model.safetensors",
             "text_encoder_2": "model.safetensors"}
SAM_KEY = "facebook/sam-vit-base"
SDXL_REFINER_KEY = "stabilityai/stable-diffusion-xl-refiner-1.0"
OWLVIT_KEY = "google/owlvit-base-patch32"
DTYPES = {"float16": torch.float16, "float32": torch.float32}


def seed_of(name: str) -> int:
    return zlib.crc32(name.encode())


def _is_norm_weight(key: str, shape) -> bool:
    return (key.endswith(".weight") and len(shape) == 1
            and ("norm" in key or "ln_" in key or "layer_norm" in key))


def _tensor(key: str, shape, seed_name: str, dtype: torch.dtype) -> torch.Tensor:
    if _is_norm_weight(key, shape):
        return torch.ones(shape, dtype=dtype)
    rng = np.random.default_rng(seed_of(f"{seed_name}/{key}"))
    x = np.asarray(rng.standard_normal(size=shape, dtype=np.float32) * np.float32(0.02))
    return torch.from_numpy(x).to(dtype)


def write_component(manifest_name: str, path: str, seed_name: str,
                    dtype: torch.dtype = torch.float32) -> int:
    """Writes one manifest's tensors to the safetensors file `path`; returns
    the number of parameters. (numpy's generators release the interpreter
    lock while they fill an array, so the threads draw in parallel.)"""
    manifest = convert.load_manifest(manifest_name)
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        values = pool.map(lambda item: _tensor(*item, seed_name, dtype), manifest.items())
        tensors = dict(zip(manifest, values))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    safetensors_io.write(tensors, path, metadata={"format": "pt"})
    return sum(t.numel() for t in tensors.values())


def fabricate_model(model_key: str, root: str, dtype: torch.dtype = torch.float32) -> int:
    base = os.path.join(root, model_key.replace("/", "--"))
    total = 0
    for component, manifest_name in sorted(convert._COMPONENT_MANIFESTS[model_key].items()):
        total += write_component(manifest_name,
                                 os.path.join(base, component, FILENAMES[component]),
                                 f"{model_key}/{component}", dtype)
    return total


def fabricate_sam(root: str, dtype: torch.dtype = torch.float32) -> int:
    return write_component(
        convert.SAM_MANIFEST,
        os.path.join(root, SAM_KEY.replace("/", "--"), "model.safetensors"),
        SAM_KEY, dtype)


def fabricate_owlvit(root: str, dtype: torch.dtype = torch.float32) -> int:
    return write_component(
        convert.OWLVIT_MANIFEST,
        os.path.join(root, OWLVIT_KEY.replace("/", "--"), "model.safetensors"),
        OWLVIT_KEY, dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--models", nargs="*", default=["gligen/diffusers-generation-text-box"],
                    choices=sorted(convert._COMPONENT_MANIFESTS))
    ap.add_argument("--sam", action="store_true", help="also facebook--sam-vit-base")
    ap.add_argument("--owlvit", action="store_true", help="also google--owlvit-base-patch32")
    ap.add_argument("--sdxl-refiner", action="store_true", help=f"also {SDXL_REFINER_KEY}")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    dtype = DTYPES[args.dtype]
    models = list(args.models)
    if args.sdxl_refiner and SDXL_REFINER_KEY not in models:
        models.append(SDXL_REFINER_KEY)
    for key in models:
        t0 = time.perf_counter()
        n = fabricate_model(key, args.root, dtype)
        print(f"{key}: {n / 1e9:.3f}B params ({args.dtype}) in "
              f"{time.perf_counter() - t0:.1f} s")
    if args.sam:
        n = fabricate_sam(args.root, dtype)
        print(f"{SAM_KEY}: {n / 1e6:.1f}M params ({args.dtype})")
    if args.owlvit:
        n = fabricate_owlvit(args.root, dtype)
        print(f"{OWLVIT_KEY}: {n / 1e6:.1f}M params ({args.dtype})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
