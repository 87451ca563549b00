"""Launchers of the port: the train, prefill and serve steps, the training
and serving loops, the device mesh and sharding plan, and the host-only
dry run and layer probe with their roofline (the port of
``repro/launch``)."""
