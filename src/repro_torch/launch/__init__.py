"""Launchers of the port: the train, prefill and serve steps, the training
and serving loops (the port of ``repro/launch``; the mesh tooling and the
dry run are still to be ported)."""
