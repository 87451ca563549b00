"""Multi-process runs for the port's distributed tests: one rank of a
``torch.distributed`` gloo group on the CPU, or the JAX package's
reference on emulated XLA host devices.

    python tests/_dist_ranks.py TASK RANK WORLD PORT OUT

runs ``TASK`` as ``RANK`` of ``WORLD`` ranks (rendezvous at
``tcp://127.0.0.1:PORT``) and ``torch.save``s its results to ``OUT``;
``python tests/_dist_ranks.py jax_TASK 0 1 0 OUT`` writes the reference
with ``numpy.savez`` (run it with ``XLA_FLAGS=
--xla_force_host_platform_device_count=N``).  :func:`run_ranks` launches
the ranks from a test, each with a timeout, so a hung collective fails the
test instead of stalling the run.
"""
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

# --------------------------------------------------------------------------
# Inputs, made from seeds with numpy (the same in every process)
# --------------------------------------------------------------------------

SEQ_S = 32  # the cache's positions, 16 a rank at 2 ranks
# (name, B, H, KV, cache lengths, insert)
SEQ_CASES = [
    ("shard0", 1, 4, 4, [5], True),
    ("seam_last_of_0", 1, 4, 4, [SEQ_S // 2 - 1], True),
    ("seam_first_of_1", 1, 4, 4, [SEQ_S // 2], True),
    ("full_no_write", 1, 4, 4, [SEQ_S], True),
    ("batch2_lengths", 2, 4, 4, [3, 20], True),
    ("gqa4", 2, 8, 2, [7, 29], True),
    ("no_insert", 2, 4, 2, [9, 17], False),
]
HD = 16


def seq_case(i):
    name, b, h, kv, lens, insert = SEQ_CASES[i]
    rng = np.random.default_rng(100 + i)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(b, 1, h, HD), k=f(b, SEQ_S, kv, HD), v=f(b, SEQ_S, kv, HD),
                kn=f(b, 1, kv, HD) if insert else None, vn=f(b, 1, kv, HD) if insert else None,
                lens=np.asarray(lens, np.int32))


ZAMBA_B, ZAMBA_S, ZAMBA_LEN, ZAMBA_STEPS = 2, 32, 14, 4


def zamba_inputs():
    """Parameters (``convert.random_lm_tree``), a filled cache of the JAX
    layout at length 14 (so the 4 steps cross the seam at 16) and the first
    tokens."""
    from repro_torch import configs
    from repro_torch.convert import random_lm_tree

    cfg = zamba_cfg(configs)
    tree = random_lm_tree(cfg, 3)
    rng = np.random.default_rng(4)
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    every = cfg.hybrid_attn_every
    groups = cfg.num_layers // every
    hd = cfg.resolved_head_dim
    kvshape = (groups, ZAMBA_B, ZAMBA_S, cfg.num_kv_heads, hd)
    cache = {
        "g_state": (0.1 * rng.standard_normal(
            (groups, every, ZAMBA_B, h, cfg.ssm_head_dim, cfg.ssm_state))).astype(np.float32),
        "g_k": rng.standard_normal(kvshape).astype(np.float32),
        "g_v": rng.standard_normal(kvshape).astype(np.float32),
        "len": np.full((ZAMBA_B,), ZAMBA_LEN, np.int32),
    }
    tok = rng.integers(0, cfg.vocab_size, (ZAMBA_B, 1)).astype(np.int32)
    return tree, cache, tok


def zamba_cfg(config_module):
    return config_module.get_config("zamba2_1p2b").reduced()


# --------------------------------------------------------------------------
# Rank tasks (PyTorch)
# --------------------------------------------------------------------------


def task_seqsharded(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.attention import decode_attention_seqsharded

    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    out = {}
    for i, (name, *_rest) in enumerate(SEQ_CASES):
        c = seq_case(i)
        n = SEQ_S // world
        t = {k: None if v is None else torch.from_numpy(v) for k, v in c.items()}
        k_sh = t["k"][:, rank * n:(rank + 1) * n].clone()
        v_sh = t["v"][:, rank * n:(rank + 1) * n].clone()
        o, k2, v2 = decode_attention_seqsharded(t["q"], k_sh, v_sh, t["lens"], mesh,
                                                k_new=t["kn"], v_new=t["vn"])
        out[name] = dict(out=o, k=k2, v=v2)
    return out


def task_zamba(rank, world):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import decode_step

    cfg = zamba_cfg(configs)
    tree, cache_np, tok = zamba_inputs()
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    n = ZAMBA_S // world
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    for k in ("g_k", "g_v"):
        cache[k] = cache[k][:, :, rank * n:(rank + 1) * n].clone()
    serve_step = make_serve_step(cfg, mesh=mesh, seq_sharded=True)
    tok = torch.from_numpy(tok)
    toks, logits = [], []
    for _ in range(ZAMBA_STEPS):
        lg, _ = decode_step(cfg, params, tok, {k: v.clone() for k, v in cache.items()},
                            mesh=mesh, seq_sharded=True)
        tok, cache = serve_step(params, tok, cache)
        toks.append(tok)
        logits.append(lg[:, -1])
    return dict(tokens=torch.cat(toks, 1), logits=torch.stack(logits), g_k=cache["g_k"],
                g_v=cache["g_v"], len=cache["len"])


# --------------------------------------------------------------------------
# References (JAX)
# --------------------------------------------------------------------------


def jax_seqsharded():
    import jax
    import jax.numpy as jnp

    from repro.models.attention import decode_attention_seqsharded

    mesh = jax.make_mesh((2, 1), ("data", "model"))
    out = {}
    for i, (name, *_rest) in enumerate(SEQ_CASES):
        c = seq_case(i)
        j = {k: None if v is None else jnp.asarray(v) for k, v in c.items()}
        fn = jax.jit(lambda q, k, v, cl, kn, vn: decode_attention_seqsharded(
            q, k, v, cl, mesh, k_new=kn, v_new=vn))
        o, k2, v2 = fn(j["q"], j["k"], j["v"], j["lens"], j["kn"], j["vn"])
        out[name + "/out"], out[name + "/k"], out[name + "/v"] = map(np.asarray, (o, k2, v2))
    return out


def jax_zamba():
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.models import decode_step

    cfg = zamba_cfg(configs)
    tree, cache_np, tok = zamba_inputs()
    params = jax.tree.map(jnp.asarray, tree)
    cache = {k: jnp.asarray(v) for k, v in cache_np.items()}
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    tok = jnp.asarray(tok)
    toks, logits = [], []
    with mesh:
        for _ in range(ZAMBA_STEPS):
            lg, cache = decode_step(cfg, params, tok, cache, mesh=mesh, seq_sharded=True)
            tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
            logits.append(np.asarray(lg[:, -1]))
    return {"tokens": np.concatenate(toks, 1), "logits": np.stack(logits),
            "g_k": np.asarray(cache["g_k"]), "g_v": np.asarray(cache["g_v"]),
            "len": np.asarray(cache["len"])}


SERVE_ARGV = ["--arch", "smollm_360m", "--reduced", "--batch", "2", "--prompt-len", "5",
              "--gen", "4", "--device", "cpu"]
TRAIN_ARGV = ["--arch", "smollm_360m", "--reduced", "--steps", "3", "--batch", "4", "--seq",
              "16", "--device", "cpu", "--log-every", "100"]


def task_boot_init(rank, world):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.train import maybe_distributed_init

    from repro_torch.runtime import ElasticMesh

    up = maybe_distributed_init("cpu")
    mesh = ElasticMesh(model_parallel=2).build([torch.device("cpu")] * world)
    dm = mesh.device_mesh
    return dict(up=up, rank=dist.get_rank(), world=dist.get_world_size(),
                backend=dist.get_backend(), grid=mesh.shape,
                device_mesh=(tuple(dm.mesh_dim_names), tuple(dm.shape), dm.device_type))


def task_boot_serve(rank, world):
    from repro_torch.launch.serve import main

    return {"gen": main(SERVE_ARGV + ["--model-parallel", "2"])}


def task_boot_train(rank, world):
    import torch

    from repro_torch.convert import lm_tree_from_params
    from repro_torch.launch.train import parse_args, train

    run = train(parse_args(TRAIN_ARGV + ["--model-parallel", "2"]))
    placements = {k: [str(p) for p in v.placements] for k, v in run.params.named_parameters()}
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = v

    walk(lm_tree_from_params(run.params), ())
    m = lm_tree_from_params(run.opt_state["m"])
    walk({"m": m}, ())
    return dict(losses=torch.tensor(run.losses, dtype=torch.float64), params=flat,
                placements=placements)


MOE_NS = (64, 16384)  # tokens: below and above the 16,384 of the capacity layout
MOE_TOP3 = 64  # tokens of the top-3 case, where a row sums three slots


def moe_inputs(n):
    rng = np.random.default_rng(n)
    e, d, f = 4, 16, 32
    w = dict(router=rng.standard_normal((d, e)), w_gate=rng.standard_normal((e, d, f)) / 4,
             w_up=rng.standard_normal((e, d, f)) / 4, w_down=rng.standard_normal((e, f, d)) / 6)
    return ({k: v.astype(np.float32) for k, v in w.items()},
            rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def moe_loss(y, aux, c):
    return (y * c).sum() + aux


def task_moe(rank, world):
    """``moe_ffn`` on a (2, 2) mesh: tokens over ``data``, the experts'
    f dim over ``model``; output, aux loss and gradients, gathered."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.moe import MoEParams, moe_ffn
    from repro_torch.models.sharding import use_mesh

    mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    lay = dict(router=[Replicate(), Replicate()], w_gate=[Replicate(), Shard(2)],
               w_up=[Replicate(), Shard(2)], w_down=[Replicate(), Shard(1)])
    out = {}
    for key, n, k in [(n, n, 2) for n in MOE_NS] + [("top3", MOE_TOP3, 3)]:
        w, x, c = moe_inputs(n)
        pw = {k: distribute_tensor(torch.from_numpy(v), mesh, lay[k]).requires_grad_(True)
              for k, v in w.items()}
        dx = distribute_tensor(torch.from_numpy(x), mesh, [Shard(0), Replicate()])
        dx.requires_grad_(True)
        dc = distribute_tensor(torch.from_numpy(c), mesh, [Shard(0), Replicate()])
        from torch.distributed.tensor.experimental import implicit_replication

        with use_mesh(mesh), implicit_replication():
            y, aux, _ = moe_ffn(dx, MoEParams(**pw), k)
            moe_loss(y, aux, dc).backward()
        out[key] = dict(y=y.full_tensor().detach(), aux=aux.full_tensor().detach(),
                      dx=dx.grad.full_tensor(),
                      **{"d" + k: v.grad.full_tensor() for k, v in pw.items()})
    return out


def task_seq(rank, world):
    return {"cases": task_seqsharded(rank, world), "zamba": task_zamba(rank, world)}


def jax_seq():
    return dict(jax_seqsharded(), **{"zamba/" + k: v for k, v in jax_zamba().items()})


TASKS = {"seq": task_seq, "boot_init": task_boot_init, "boot_serve": task_boot_serve,
         "boot_train": task_boot_train, "moe": task_moe}
JAX_TASKS = {"jax_seq": jax_seq}


# --------------------------------------------------------------------------
# Launching
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra or {})
    return env


def _wait(procs, timeout):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = [(i, p.returncode, p.stderr.read().decode()[-3000:]) for i, p in enumerate(procs)
            if p.returncode != 0]
    if errs:
        raise RuntimeError(f"ranks failed: {errs}")


def run_ranks(task, world, tmp_path, timeout=120):
    """Run ``task`` on ``world`` gloo ranks; returns each rank's results.
    A ``boot_`` task joins its group itself, through the launchers'
    ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
    bootstrap."""
    import torch

    port = free_port()
    outs = [str(tmp_path / f"{task}_{r}.pt") for r in range(world)]

    def env(r):
        if not task.startswith("boot_"):
            return _env()
        return _env({"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": str(world),
                     "PROCESS_ID": str(r)})

    procs = [subprocess.Popen([sys.executable, __file__, task, str(r), str(world), str(port),
                               outs[r]], env=env(r), stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE) for r in range(world)]
    _wait(procs, timeout)
    return [torch.load(o, weights_only=False) for o in outs]


def run_jax(task, devices, tmp_path, timeout=300):
    out = str(tmp_path / f"{task}.npz")
    p = subprocess.run([sys.executable, __file__, task, "0", "1", "0", out],
                       env=_env({"XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
                                 "JAX_PLATFORMS": "cpu"}),
                       capture_output=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(p.stderr.decode()[-3000:])
    return dict(np.load(out))


def main(task, rank, world, port, out):
    if task in JAX_TASKS:
        np.savez(out, **JAX_TASKS[task]())
        return
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if not task.startswith("boot_"):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
    try:
        torch.save(TASKS[task](rank, world), out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
