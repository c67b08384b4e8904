#!/usr/bin/env python3
"""Which collectives torch's gloo backend takes on CUDA tensors, and what a
float32 all-reduce costs through host copies and through gloo's CUDA form:
two ranks on one card (the layout of `chip_smoke.py` phase 16 (b), where
NCCL refuses two ranks on one device).

    python3 scripts/torch_gloo_probe.py [--out chiprun_out/gloo_probe.json]

Starts its two ranks itself on localhost and prints one JSON object: each
collective "ok" or the error gloo raised, and the median of five
all-reduces at 5 MB and 42 MB (phase 16's largest tensor-split activation,
(8, 4096, 320) in float32), in ms, with the card's name and power limit.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def rank_main(rank: int, port: int, out_path: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    x = torch.ones(1024, device="cuda")
    u8 = torch.zeros(8, dtype=torch.uint8, device="cuda")
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
            ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x)),
            ("all_reduce_bf16", lambda: dist.all_reduce(x.bfloat16())),
            ("all_gather_uint8",
             lambda: dist.all_gather([torch.empty_like(u8) for _ in range(2)], u8))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:  # what gloo refuses is the finding
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
        dist.barrier()
    for mb in (5, 42):
        y = torch.randn(mb * 2**20 // 4, device="cuda")
        for how in ("host", "cuda"):
            if how == "cuda" and out["all_reduce"] != "ok":
                continue
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                if how == "host":
                    h = y.cpu()
                    dist.all_reduce(h)
                    h.to("cuda")
                else:
                    dist.all_reduce(y.clone())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[f"all_reduce_{mb}MB_{how}_ms"] = sorted(times)[2] * 1e3
    if rank == 0:
        out["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/gloo_probe.json")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.port, args.out)
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--port", str(port),
                               "--out", args.out]) for r in range(2)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    sys.exit(max(codes))


if __name__ == "__main__":
    main()
