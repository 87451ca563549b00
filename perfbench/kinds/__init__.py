"""One module a traffic kind (``<kind>.py``), found by the ``kind`` a
traffic file names.  Each has ``load_traffic(path)``, the traffic
(``perfbench/traffic.py`` for the prefill kinds); ``Driver(cell, seed,
device, step_factory)``, which sets up the model and drives the cell's entry
(``warm_up``, ``window(seconds)``, ``traced``, ``describe``, ``check``);
``end_to_end(records, window_s)``, the end-to-end metrics by name; and
``readings(cell, seed, side, device)``, the check's readings of a seed for
``control.py``.  A later kind (decode, training) is a new file here and a
traffic file that names it."""
