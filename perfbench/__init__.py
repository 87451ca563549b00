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
  finds nothing to read;
- ``reference/<family>.py``: the plain float32 forward of a model family;
- ``counts/<name>.py``: operation and byte counts (model FLOPs, K5, K6).

Nothing here imports JAX or the JAX package (``repro``); the program under
test is ``repro_torch``, taken from ``src/`` of the checkout.
"""
