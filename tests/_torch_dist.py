"""Multi-rank helpers of the port's dist tests (`tests/test_torch_dist_*.py`).

`run_ranks(job, world, args, tmp_path)` starts `python -m tests._torch_dist`
`world` times on localhost: each process runs on the CPU with one torch
thread, joins a gloo group through `dist.mesh.initialize_multihost`, runs
`JOBS[job](args)` and saves what it returns. A process that fails, or a run
that outlives its timeout, stops every process and fails the test with each
process's output.

The processes import torch and the port only; the tests compute the JAX
references themselves and hand the port the same weights as state dicts.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(job: str, world: int, args: dict, tmp_path, timeout: float = 240.0) -> list:
    """What `JOBS[job](args)` returned on each rank, in rank order."""
    from lmdx_torch.dist import mesh as meshlib

    work = Path(tmp_path) / f"{job}_{world}"
    work.mkdir(parents=True, exist_ok=True)
    torch.save(args, work / "args.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT)] + [p for p in [os.environ.get(
               "PYTHONPATH")] if p])}
    for name in ("LMDX_COORDINATOR", "LMDX_NUM_PROCESSES", "LMDX_PROCESS_ID"):
        env.pop(name, None)
    port = meshlib.free_port()
    logs = [open(work / f"log_{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests._torch_dist", job, str(r), str(world), str(port),
         str(work)], env=env, cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        out = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                        f"{(work / f'log_{r}.txt').read_text()[-4000:]}"
                        for r, c in enumerate(codes))
        raise AssertionError(f"{job} on {world} ranks failed or timed out after "
                             f"{timeout} s:\n{out}")
    return [torch.load(work / f"out_{r}.pt", weights_only=False) for r in range(world)]


def _bundle(args, kernels=None):
    from lmdx_torch import config as tconfig
    from lmdx_torch.runtime import models as tmodels

    return tmodels.build_bundle(tconfig.SD_CONFIGS["tiny-test"](), args["state_dicts"],
                                device="cpu", kernels=kernels)


def job_tp_unet(args) -> dict:
    """The tiny UNet at tp 2 (forward, and the latents' gradient through the
    guidance loss on the gathered taps), once per kernel option."""
    from lmdx_torch.config import ALL_KERNELS
    from lmdx_torch.dist import mesh as meshlib
    from lmdx_torch.nn.unet import apply_unet
    from lmdx_torch.sampling import guidance as tguid

    out = {}
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    for name, kernels in (("default", None), ("all_kernels", ALL_KERNELS)):
        bundle = _bundle(args, kernels)
        mesh = meshlib.make_mesh(tp=2, device="cpu")
        unet = meshlib.shard_params(bundle.unet, mesh)
        split = {n: p.shape for n, p in unet.named_parameters()}
        with torch.no_grad():
            eps = apply_unet(unet, t(args["lat"]), 501, t(args["ctx"]), objs=t(args["objs"]))[0]
        spec = tguid.GuidanceSpec(**args["spec"])
        data = tguid.guidance_data_to_device(args["data"], "cpu")
        ref = {k: t(v) for k, v in args["ref"].items()}
        x = t(args["lat"][:1]).clone().requires_grad_(True)
        taps = apply_unet(unet, x, 501, t(args["ctx"][1:]), objs=t(args["objs"][1:]),
                          taps=spec.tap_spec, stop_after_taps=True)[1]
        loss = tguid.ca_loss(taps, data, spec, ref_taps=ref)
        (grad,) = torch.autograd.grad(loss, x)
        out[name] = {"eps": eps.numpy(), "grad": grad.numpy(), "loss": float(loss.detach()),
                     "tap_shapes": {k: tuple(v.shape) for k, v in taps.items()},
                     "shapes": split,
                     "heads": sorted({m.heads for m in unet.modules() if hasattr(m, "heads")})}
    return out


def job_batch(args) -> dict:
    """`run_<method>_batch` under a dp x tp mesh, then (with `own`) this dp
    row's share without the mesh in this process."""
    from lmdx_torch.dist import serve
    from lmdx_torch.methods import batch as tbatch

    run = getattr(tbatch, f"run_{args['method']}_batch")
    bundle = _bundle(args)
    mesh, sharded = serve.activate_mesh(bundle, dp=args["dp"], tp=args["tp"])
    row = mesh.dp_index
    local, counts = tbatch._run_local, []

    def counting(specs, *a):
        counts.append(len(specs))
        return local(specs, *a)

    tbatch._run_local = counting
    try:
        images = np.stack([r.image for r in run(args["specs"], sharded, **args["kwargs"])])
    finally:
        tbatch._run_local = local
        serve.deactivate_mesh()
    out = {"images": images, "dp_index": row, "local_batches": counts}
    if args.get("own"):
        n = len(args["specs"]) // args["dp"]
        sl = slice(row * n, (row + 1) * n)
        kw = dict(args["kwargs"])
        kw.update(bg_seeds=kw["bg_seeds"][sl], fg_seed_starts=kw["fg_seed_starts"][sl])
        out["own"] = np.stack([r.image for r in run(args["specs"][sl], bundle, **kw)])
    return out


def job_train(args) -> dict:
    """One sharded train step at dp 2 x tp 2 from the whole float32 UNet;
    the adapter mask at tp 2; a checkpoint saved at tp 2 restored at tp 1,
    and one saved at tp 1 restored at tp 2."""
    from lmdx_torch import config as tconfig
    from lmdx_torch.dist import mesh as meshlib
    from lmdx_torch.runtime import models as tmodels
    from lmdx_torch.training import checkpoint as tckpt
    from lmdx_torch.training import train as ttrain

    cfg = tconfig.SD_CONFIGS["tiny-test"]()
    lr = args["lr"]

    def objs_fn(_, batch):
        return batch["objs"]

    def fresh(mask=False):
        unet = tmodels.build_train_unet(cfg, args["unet"], device="cpu")
        opt = ttrain.make_optimizer(
            lr, trainable_mask=ttrain.gligen_adapter_mask(unet) if mask else None)
        return ttrain.init_train_state(unet, opt), opt

    mesh = meshlib.make_mesh(dp=2, tp=2, device="cpu")
    state, opt = fresh()
    sstate = ttrain.shard_state(state, mesh)
    step = ttrain.make_sharded_train_step(sstate.params, opt, args["alphas"], mesh,
                                          objs_fn=objs_fn)
    batch = meshlib.shard_batch({k: torch.from_numpy(v) for k, v in args["batch"].items()},
                                mesh)
    new, loss = step(sstate, batch)
    splits = meshlib.split_params(new.params)
    named = dict(new.params.named_parameters())
    moments = {n: new.opt_state.state[p] for n, p in named.items()}
    out = {"loss": float(loss), "batch_rows": int(batch["x0"].shape[0]),
           "local_shapes": {n: tuple(p.shape) for n, p in named.items()},
           "moment_shapes": {n: tuple(m["exp_avg"].shape) for n, m in moments.items()},
           "spec": meshlib.param_spec(state.params, 2),
           "params": {n: meshlib.whole_tensor(splits.get(n), p.detach()).numpy()
                      for n, p in named.items()},
           "exp_avg": {n: meshlib.whole_tensor(splits.get(n), m["exp_avg"]).numpy()
                       for n, m in moments.items()}}

    # The adapter mask at tp 2: the same trained names, the rest frozen.
    mstate, mopt = fresh(mask=True)
    mshard = ttrain.shard_state(mstate, mesh)
    before = {n: p.detach().clone() for n, p in mshard.params.named_parameters()}
    mstep = ttrain.make_sharded_train_step(mshard.params, mopt, args["alphas"], mesh,
                                           objs_fn=objs_fn)
    mshard, _ = mstep(mshard, batch)
    trained = {n for n, p in mshard.params.named_parameters() if p.requires_grad}
    out["mask"] = {"trained": trained, "opt_count": sum(
        len(g["params"]) for g in mshard.opt_state.param_groups),
        "changed": {n for n, p in mshard.params.named_parameters()
                    if not torch.equal(p.detach(), before[n])}}

    # Saved at tp 2, restored at tp 1; saved at tp 1, restored at tp 2.
    root = Path(args["ckpt"])
    tckpt.save(str(root / "tp2"), new)
    one, _ = fresh()
    one = tckpt.restore(str(root / "tp2"), one)
    one_named = dict(one.params.named_parameters())
    out["restored_tp1"] = {
        "params": {n: p.detach().numpy() for n, p in one_named.items()},
        "exp_avg": {n: one.opt_state.state[p]["exp_avg"].numpy()
                    for n, p in one_named.items()},
        "step": one.step}
    tckpt.save(str(root / "tp1"), one)
    back, _ = fresh()
    back = tckpt.restore(str(root / "tp1"), ttrain.shard_state(back, mesh))
    back_named = dict(back.params.named_parameters())
    out["restored_tp2_equal"] = all(
        torch.equal(back_named[n], named[n])
        and torch.equal(back.opt_state.state[back_named[n]]["exp_avg"], moments[n]["exp_avg"])
        and torch.equal(back.opt_state.state[back_named[n]]["exp_avg_sq"],
                        moments[n]["exp_avg_sq"])
        for n in named)
    out["restored_tp2_step"] = back.step
    return out


JOBS = {"tp_unet": job_tp_unet, "batch": job_batch, "train": job_train}


def main() -> None:
    job, rank, world, port, work = sys.argv[1:]
    torch.set_num_threads(1)
    from lmdx_torch.dist import mesh as meshlib

    meshlib.initialize_multihost(f"localhost:{port}", int(world), int(rank), device="cpu")
    args = torch.load(Path(work) / "args.pt", weights_only=False)
    out = JOBS[job](args)
    torch.save(out, Path(work) / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
