"""Per-layer metric readers, one file a metric (``<metric>.py``), each with
``read(ctx)`` (``ctx`` is ``bench.Context``): the metric's value, or ``None``
where the run holds nothing for it to read."""
