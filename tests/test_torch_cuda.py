"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``: it skips on a machine without a card, and it imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

It builds K1 (``lru_hits``), K2 (``fused_levels``) and the ordered segment
sum with ``nvcc`` and holds each against its plain PyTorch version bit for
bit, on the families ``chip_smoke.py`` uses.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    dev = torch.device("cuda", 0)
    assert chip_smoke.k1_families(dev) == 0
    assert chip_smoke.k2_families(dev) == 0
    assert chip_smoke.segment_sum_check(dev) == 0
