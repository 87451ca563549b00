"""Multi-pod dry run: trace one rank's step of every (arch x shape x mesh)
cell (the port of ``repro/launch/dryrun.py``).  A host-only tool: it
touches no card.

    python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only | --single-pod-only]

What stands in for the JAX dry run's tools:

- XLA's 512 emulated host devices and SPMD partitioner: PyTorch's
  ``fake`` process-group backend at world size 256 (512 multi-pod), this
  process as rank 0 (``launch/mesh.py``), and DTensor: the parameters,
  optimizer state, batch and cache are fake tensors (no allocation) laid
  out on the production ``DeviceMesh`` by the sharding plan
  (``models/sharding.py``), and the step runs eagerly on them; DTensor
  gives each op its rank's shard and issues the collectives a layout
  change needs.  The model runs the plain versions of K5 and K6 on these
  CPU tensors, as the JAX dry run lowers the jnp paths and not Pallas.
- ``cost_analysis()``: :class:`StepCounter`, a dispatch mode that sees the
  rank's local ops (it lets DTensor run first) and adds up their FLOPs
  (``torch.utils.flop_counter``'s formulas, those of ``FlopCounterMode``)
  and their bytes (each op's inputs and outputs: XLA-CPU's unfused
  "bytes accessed" convention; views, collectives and metadata
  queries such as ``prim.device`` excluded).
- The HLO's collectives: ``CommDebugMode`` (``launch/hlo_analysis.py``'s
  ``CommBytesMode``), each collective's result bytes on the rank.  The
  ``fake`` backend is a CPU group, on which DTensor's all-to-all falls
  back to an all-gather and a chunk.
- ``memory_analysis()``: ``argument_size_in_bytes`` is the rank's shards of
  the inputs, ``output_size_in_bytes`` of what the step returns (the
  port's steps update the parameters, optimizer state and cache in place
  and return them), ``temp_size_in_bytes`` the peak of the bytes the step
  allocated beyond its arguments (storages tracked by the same mode).

Where DTensor has no sharding rule for an op the model uses, the layout is
made explicit at that point: the embedding lookup and the loss's label
gather into a vocabulary split over ``model`` (``reduce_partial``), the
decode cache writes (``write_rows``, ``assign``) and the sequence-sharded
attention (``decode_attention_seqsharded``, on each rank's local shards).

Writes one JSON per cell under ``results/dryrun_torch/`` with JAX's
record keys; ``trace_s`` (host seconds of the traced step) stands in for
``lower_s`` / ``compile_s``.  A cell that fails writes ``status:
"error"`` and the error.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.hlo_analysis import CommBytesMode, comm_bytes
from repro_torch.launch.mesh import fake_process_group, mesh_num_devices, production_shape
from repro_torch.launch.steps import cell_step_and_specs

OUT_DIR = "results/dryrun_torch"


def _tensors(x) -> list:
    """The tensors of a pytree, an ``nn.Module`` in it standing for its
    parameters."""
    out = []
    for t in tree_leaves(x):
        if isinstance(t, torch.nn.Module):
            out += list(t.parameters())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def local_bytes(x) -> int:
    """Bytes of the rank's shards of the tensors in ``x`` (an ``nn.Module``
    counts its parameters)."""
    return sum(_local(t).numel() * _local(t).element_size() for t in _tensors(x))


def _moves_data(func) -> bool:
    """Whether an op returns a tensor or writes one (``prim.device``,
    ``aten.sym_size`` and the like only read metadata)."""
    schema = func._schema
    return schema.is_mutable or any("Tensor" in str(r.type) for r in schema.returns)


class StepCounter(CommBytesMode):
    """The rank's FLOPs, op bytes, new-storage peak and collectives of the
    ops run while it is entered."""

    def __init__(self, known=()):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in _tensors(known):
            self._seen[_local(t).untyped_storage()] = 0

    def _free(self, n):
        self.live -= n

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = len(self.calls)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        tensors = _tensors((args, kwargs, out))
        if _BOOKKEEPING[0] or not any(isinstance(t, FakeTensor) for t in tensors):
            return out  # DTensor's bookkeeping (_dtensor_bookkeeping), not the step's
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if len(self.calls) == before and not getattr(func, "is_view", False) and _moves_data(func):
            self.op_bytes += sum(t.numel() * t.element_size() for t in tensors)
        self._track(out)
        return out


def _fake_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, in_specs, in_shardings):
    """The cell's inputs as fake CPU tensors (the caller's ``FakeTensorMode``)
    laid out on ``mesh`` by their plans."""
    from repro_torch.models.model import LM
    from repro_torch.models.sharding import distribute, distribute_params

    def fake(meta: dict) -> dict:
        return {k: torch.empty(v.shape, dtype=v.dtype) for k, v in meta.items()}

    model = distribute_params(LM(cfg, device="cpu"), mesh)
    if shape.mode == "train":
        from repro_torch.optim.adamw import AdamWConfig, adamw_init

        model.requires_grad_(True)
        # zeros_like of the DTensor parameters: the state follows their plan
        opt = adamw_init(dict(model.named_parameters()),
                         AdamWConfig(state_dtype=cfg.opt_state_dtype))
        _, _, bspec = in_specs
        return model, opt, distribute(fake(bspec), in_shardings[2], mesh)
    if shape.mode == "prefill":
        return model, distribute(fake(in_specs[1]), in_shardings[1], mesh)
    _, tspec, cspec = in_specs
    tok = distribute({"t": fake({"t": tspec})["t"]}, {"t": in_shardings[1]}, mesh)["t"]
    return model, tok, distribute(fake(cspec), in_shardings[2], mesh)


_BOOKKEEPING = [0]  # depth of DTensor's own shape inference, whose ops are not the step's


def _patch(cls, name, wrap, stack):
    """Wrap ``cls.name`` until ``stack`` closes.  A torch without it raises:
    the counts would otherwise take DTensor's bookkeeping for the step's
    work with no sign of it."""
    orig = getattr(cls, name, None)
    if orig is None:
        raise RuntimeError(f"torch {torch.__version__} has no {getattr(cls, '__name__', cls)}."
                           f"{name}, which the dry run's DTensor fixes wrap")
    setattr(cls, name, functools.wraps(orig)(wrap(orig)))
    stack.callback(setattr, cls, name, orig)


@contextlib.contextmanager
def _dtensor_bookkeeping():
    """Three fixes to DTensor's bookkeeping under a fake-tensor trace:

    - under a fake mode DTensor takes itself to be compiling and plans every
      candidate layout change of every strategy afresh
      (``_gen_transform_infos_non_cached``: a graph search where a dim is
      split over two mesh axes, minutes an op on a 3-D mesh): the shapes
      here are concrete, so the plans are memoized as outside a trace, and
      the plans that only price a candidate strategy (``redistribute_cost``)
      are the greedy planner's; the layout changes that run keep the graph
      search's plans;
    - its sharding propagator infers an op's output shape by running the op
      on whole-shaped fake tensors, once an op and layout (while its cache
      fills): those runs are marked so that :class:`StepCounter` does not
      count them as the rank's work;
    - ``_StridedShard`` (a dim split over two mesh axes, as the batch and
      heads merged into one batch dim of an einsum's ``bmm``) computes its
      shard's offsets with ``torch.arange(...).tolist()``, which a
      ``FakeTensorMode`` cannot answer: that runs on real (small, index)
      tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute, _sharding_prop, placement_types

    def marked(orig):
        def run(*args, **kwargs):
            _BOOKKEEPING[0] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                _BOOKKEEPING[0] -= 1
        return run

    def real(orig):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return orig(*args, **kwargs)
        return run

    pricing = [0]

    def priced(orig):
        def run(*args, **kwargs):
            pricing[0] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                pricing[0] -= 1
        return run

    def memoized(orig):
        plans = {}

        def run(src, dst, *args):
            key = (src, dst, args, bool(pricing[0]))
            if key not in plans:
                if pricing[0]:
                    drp = _redistribute.get_redistribute_planner(src.mesh, src.tensor_meta)
                    plans[key] = drp.generate_greedy_transform_infos(src, dst)
                else:
                    plans[key] = orig(src, dst, *args)
            return plans[key]
        return run

    from torch.distributed.tensor import _utils
    from torch.distributed.tensor._ops import utils as ops_utils

    with contextlib.ExitStack() as stack:
        _patch(_redistribute, "_gen_transform_infos_non_cached", memoized, stack)
        _patch(ops_utils, "redistribute_cost", priced, stack)
        _patch(_utils, "redistribute_cost", priced, stack)
        _patch(_sharding_prop.ShardingPropagator, "_propagate_tensor_meta_non_cached", marked,
               stack)
        _patch(placement_types._StridedShard, "local_shard_size_and_offset", real, stack)
        yield


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """One rank's step of the cell on ``mesh`` (under an up process group):
    FLOPs, op bytes, collectives, the memory record and the trace
    seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    step, in_specs, in_shardings = cell_step_and_specs(cfg, shape, mesh)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode, _dtensor_bookkeeping():
        inputs = _fake_inputs(cfg, shape, mesh, in_specs, in_shardings)
        t0 = time.perf_counter()
        with StepCounter(known=inputs) as counter:
            outs = step(*inputs)
        trace_s = time.perf_counter() - t0
    return dict(
        flops=float(counter.flops),
        bytes_accessed=float(counter.op_bytes),
        collectives=comm_bytes(counter),
        memory={"argument_size_in_bytes": local_bytes(inputs),
                "output_size_in_bytes": local_bytes(outs),
                "temp_size_in_bytes": int(counter.peak)},
        trace_s=trace_s,
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str = OUT_DIR,
             cfg: Optional[ModelConfig] = None, shape: Optional[ShapeConfig] = None,
             mesh_shape: Optional[tuple] = None) -> dict:
    """The record of one cell, written to ``out_dir`` (a record already
    there is read back, as the JAX tool skips it).  ``cfg``, ``shape`` and
    ``mesh_shape`` replace the arch's config, the named shape and the
    production mesh (a reduced cell)."""
    pod = "pod2" if multi_pod else "pod1"
    tag = f"{arch}__{shape_name}__{pod}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path):
        print(f"[skip] {tag}")
        with open(path) as f:
            return json.load(f)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    dims, axes = production_shape(multi_pod)
    if mesh_shape is not None:
        dims = mesh_shape
    rec = {"arch": arch, "shape": shape_name, "mesh": "x".join(map(str, dims)),
           "mode": shape.mode}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        _dump(path, rec)
        print(f"[skipped-by-design] {tag}: {why}")
        return rec
    try:
        from torch.distributed.device_mesh import init_device_mesh

        n = 1
        for d in dims:
            n *= d
        with fake_process_group(n):
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
            rec.update(status="ok", devices=mesh_num_devices(mesh), **trace_cell(cfg, shape, mesh),
                       param_count=cfg.param_count(), active_param_count=cfg.active_param_count())
        print(f"[ok] {tag}: trace {rec['trace_s']:.1f}s flops={rec['flops']:.3g} "
              f"coll={rec['collectives']['total_bytes']:.3g}B")
    except Exception as e:  # noqa: BLE001 -- the record says what failed
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000])
        traceback.print_exc()
        print(f"[ERROR] {tag}: {e}")
    _dump(path, rec)
    return rec


def _dump(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    cells = []
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    for a in archs:
        for s in shapes:
            if not args.multi_pod_only:
                cells.append((a, s, False))
            if not args.single_pod_only:
                cells.append((a, s, True))
    if args.multi_pod and not args.all and args.arch:
        cells = [(args.arch, s, True) for s in shapes]
    return [run_cell(a, s, mp, args.out) for a, s, mp in cells]


if __name__ == "__main__":
    main()
