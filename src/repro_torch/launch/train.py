"""Training launcher (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

on the card; ``--reduced --device cpu`` runs the reduced config on the
CPU.  As in the JAX launcher: the device grid comes from ``ElasticMesh``;
the parameters from ``init_params`` (here with a ``torch.Generator`` seeded
with ``--seed``, on the launcher's device); batches from ``SyntheticLMData``
as a pure function of the step; ``CheckpointManager`` resumes from the
newest usable checkpoint, in the JAX package's format, so either launcher
resumes from the other's checkpoints; ``StragglerMonitor`` records each
step's host time (the card synchronized before the clock is read);
``--grad-compress`` allocates the int8 error-feedback buffer and, as in the
JAX launcher, nothing more.  The train state on disk is ``(params,
{"m", "step", "v"})`` in the JAX package's pytree layout
(``convert.lm_tree_from_params``).

Several processes: ``COORDINATOR_ADDRESS`` (``host:port``),
``NUM_PROCESSES`` and ``PROCESS_ID`` (the JAX launcher's variables) bring
up a ``torch.distributed`` group (NCCL on the card, gloo on the CPU), one
rank a process.  The grid then spans the ranks, with ``--model-parallel``
on its ``model`` axis; the parameters, optimizer state and batches are
laid out on it by the sharding plan (DTensors), and the gradient
all-reduce is DTensor's.  Rank 0 writes the checkpoints, gathered whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import lm_tree_from_params, load_lm_tree
from repro_torch.data import SyntheticLMData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import LM, init_params
from repro_torch.models.sharding import batch_shardings, distribute, distribute_params, whole
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.grad_compress import init_error_buf
from repro_torch.runtime import ElasticMesh, StragglerMonitor


def maybe_distributed_init(device: DeviceLike = None) -> bool:
    """Join the process group that ``COORDINATOR_ADDRESS`` (``host:port``),
    ``NUM_PROCESSES`` and ``PROCESS_ID`` describe (NCCL for the card, gloo
    for the CPU), if they are set and no group is up; returns whether a
    group is up."""
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if addr and not dist.is_initialized():
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                world_size=int(os.environ.get("NUM_PROCESSES", "1")),
                                rank=int(os.environ.get("PROCESS_ID", "0")))
    return dist.is_initialized()


def rank_devices(device: DeviceLike = None) -> list:
    """``(this rank's device, one device a rank)``: the process's device
    alone outside a process group; within one, ``cuda:(rank % cards)`` (made
    current) or the CPU for every rank."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return dev, [dev]
    world = dist.get_world_size()
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        dev = torch.device("cuda", dist.get_rank() % n)
        torch.cuda.set_device(dev)
        return dev, [torch.device("cuda", r % n) for r in range(world)]
    return dev, [dev] * world


def train_state(params: LM, opt_state: dict) -> tuple:
    """The train state as the JAX launcher saves it: ``(params, {"m",
    "v", "step"})`` in the JAX package's pytree layout."""
    return (lm_tree_from_params(params),
            {"m": lm_tree_from_params(opt_state["m"]), "v": lm_tree_from_params(opt_state["v"]),
             "step": opt_state["step"]})


def load_train_state(params: LM, opt_state: dict, state: tuple) -> None:
    """Copy a restored :func:`train_state` into ``params`` and
    ``opt_state`` in place."""
    tree, opt = state
    load_lm_tree(dict(params.named_parameters()), tree)
    load_lm_tree(opt_state["m"], opt["m"])
    load_lm_tree(opt_state["v"], opt["v"])
    opt_state["step"] = opt["step"].to(torch.int32)


@dataclasses.dataclass
class TrainRun:
    losses: List[float]
    params: LM
    opt_state: dict
    start_step: int
    step_s: List[float]  # host seconds of each step, synchronized
    ckpt_s: List[float]  # host seconds of each save
    ckpt_paths: List[str]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, device: DeviceLike = None) -> TrainRun:
    """The launcher's run: what :func:`main` does, returning the state it
    ends with and its timings."""
    device = args.device if device is None else device
    maybe_distributed_init(device)
    dev, devices = rank_devices(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat_policy="none" if args.reduced else cfg.remat_policy)

    elastic = ElasticMesh(model_parallel=args.model_parallel)
    mesh = elastic.build(devices)
    dmesh = mesh.device_mesh
    print(f"mesh: {mesh.shape} devices={mesh.devices.size}")

    ocfg = AdamWConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    params = init_params(cfg, args.seed, device=dev).requires_grad_(True)
    if dmesh is not None:
        distribute_params(params, dmesh)
    named = dict(params.named_parameters())
    opt_state = adamw_init(named, ocfg)
    # allocated and left unused, as in the JAX launcher (whose cross-pod EF-int8
    # all-reduce is exercised only in its tests)
    err_buf = init_error_buf(named) if args.grad_compress else None  # noqa: F841
    step_fn = make_train_step(cfg, ocfg)

    data = SyntheticLMData(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq,
        global_batch=args.batch,
        seed=args.seed,
        num_shards=1,
        shard=0,
    )

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        latest = ckpt.latest_step()
        if latest is not None:
            restored, start_step = ckpt.restore(train_state(params, opt_state))
            load_train_state(params, opt_state, restored)
            print(f"[resume] from step {start_step}")

    monitor = StragglerMonitor()
    run = TrainRun([], params, opt_state, start_step, [], [], [])
    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
        if dmesh is not None:  # every rank holds the same global batch
            batch = distribute(batch, batch_shardings(cfg, dmesh, batch), dmesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        loss = float(whole(metrics["loss"]))
        monitor.record(host=0, step_time=dt)
        run.losses.append(loss)
        run.step_s.append(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            state = train_state(params, opt_state)  # gathered on every rank
            if dmesh is None or dist.get_rank() == 0:
                path = ckpt.save(step + 1, state)
                run.ckpt_paths.append(path)
                print(f"[ckpt] {path}")
            if dmesh is not None:
                dist.barrier()
            run.ckpt_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_start
    if run.losses:
        print(
            f"done: {args.steps - start_step} steps in {wall:.1f}s; "
            f"loss {run.losses[0]:.3f} -> {run.losses[-1]:.3f}"
        )
    return run


def main(argv=None, device: DeviceLike = None) -> List[float]:
    """Run the launcher on ``argv``; returns the losses of the steps it
    took.  ``device`` overrides ``--device``."""
    return train(parse_args(argv), device).losses


if __name__ == "__main__":
    main()
