"""Launchers of the port: the prefill and serve steps and the serving
loop (the port of ``repro/launch``; training and the mesh tooling are
still to be ported)."""
