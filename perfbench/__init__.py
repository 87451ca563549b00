"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON result
line.  Everything that belongs to one configuration, traffic mix, cell,
per-layer metric, reference family or operation count is a file of its own
under this folder, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes as run, its source and cuts;
- ``traffic/<traffic>.json``: the parameters ``traffic.py`` generates from,
  and the ``kind`` of the traffic;
- ``kinds/<kind>.py``: the entry a kind of traffic drives, its loop and its
  end-to-end metrics;
- ``workloads/<cell>.json``: what the check samples and the limits it holds;
- ``metrics/<metric>.py``: a reader with ``read(ctx)``, ``None`` when it
  finds nothing to read.  A new cell that reports a quantity whose entry
  lists other cells adds an entry ``<metric>.<suffix>`` (its ``workloads``
  the new cell), which the same reader reads (``bench.metric_reader``);
- ``reference/<family>.py``: a model family's plain float32 forward
  (``run``, ``program_parts``) and the leaves it reads (``tree_shapes``;
  optionally ``draw_leaf``, its own draw of a leaf);
- ``counts/model_<family>.py``: a family's model FLOPs (``flops``) and the
  kernels' calls it makes a forward (``attention_calls``, ``ssm_layers``);
- ``counts/<kernel>.py``: a kernel's operation and byte counts (K5, K6).

A model family the program runs joins as files: its reference and its
counts, a configuration, a traffic mix, a cell, and entries appended to
``BENCHMARK.json``.  A family with no such file is refused by name
(:func:`family_module`).

Nothing here imports JAX or the JAX package (``repro``); the program under
test is ``repro_torch``, taken from ``src/`` of the checkout.
"""
import importlib


def family_module(folder: str, name: str):
    """The module ``perfbench/<folder>/<name>.py`` of a model family or a
    kernel; a missing file is named in the error."""
    full = f"perfbench.{folder}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ModuleNotFoundError(f"no perfbench/{folder}/{name}.py: the benchmark holds no "
                                  f"{folder} of this name", name=full) from None
