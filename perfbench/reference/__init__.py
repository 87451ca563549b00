"""Plain float32 reference forwards, one file a model family
(``<family>.py``), each with ``run(cfg, tree, tokens, mm)``, which yields
``(part name, tensor)`` for every part of the prefill's output in the
program's order and ``("logits", (B, V))`` last, and ``program_parts(cfg,
cache)``, the program's returned cache under the same part names."""
