"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``: it skips on a machine without a card, and it imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

It builds K1 (``lru_hits``), K2 (``fused_levels``), the ordered segment
sum, K3 (the BaseΔ tile kernels) and K4 (the AMC gather kernels) with
``nvcc`` and holds each against its plain PyTorch version bit for bit, on
the families ``chip_smoke.py`` uses; K5 (``flash_attention``) and K6
(``ssd_scan``) against their plain versions within ``chip_smoke.py``'s
stated tolerances; and the reduced zamba2 on the card against the JAX
package's golden record (``tests/data/torch_port_golden_lm.json``).
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


@pytest.mark.cuda
def test_recorded_stream_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    dev = torch.device("cuda", 0)
    assert chip_smoke.k3_families(dev) == 0
    assert chip_smoke.k4_families(dev) == 0


@pytest.mark.cuda
def test_lm_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.k5_families(dev)  # each raises on an element outside its tolerance
    chip_smoke.k6_families(dev)


@pytest.mark.cuda
def test_reduced_lm_matches_golden_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import json

    import chip_smoke

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attn.flash_attn import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    before = (flash_attention.launches, ssd_scan.launches)
    for rec in json.loads(chip_smoke.GOLDEN_LM.read_text())["records"]:
        chip_smoke.lm_golden_check(rec, dev)
    assert flash_attention.launches > before[0] and ssd_scan.launches > before[1]
