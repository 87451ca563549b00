"""Operation and byte counts, frozen with the benchmark: one file a model
family, ``model_<family>.py`` (``flops(cfg, rows, length)``, the model FLOPs
of one prefill batch; ``attention_calls(cfg)`` and ``ssm_layers(cfg)``, the
K5 and K6 calls of one forward, which the kernels' files ask for), and one
file a kernel (``KERNELS``, the substrings of its device kernels' names,
and ``launches(cfg, rows, length)``, the ``(operations, bytes)`` of each
launch a prefill batch makes)."""
