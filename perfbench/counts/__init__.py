"""Operation and byte counts, frozen with the benchmark: ``model_<family>.py``
(``flops(cfg, rows, length)``, the model FLOPs of one prefill batch) and one
file a kernel (``KERNELS``, the substrings of its device kernels' names, and
``launches(cfg, rows, length)``, the ``(operations, bytes)`` of each launch a
prefill batch makes)."""
