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
stated tolerances, the Mamba2 gate (``ssm_gate``) within one bfloat16
step, K5 also alone at the shapes of the moe, vlm and encdec families
(cross-attention 448 x 1,500, GQA groups of 6 and 7 at hd 128, a
4,096-key window over 8,192 positions); the reduced zamba2 on the card
against the JAX package's golden record
(``tests/data/torch_port_golden_lm.json``), and the reduced mixtral,
qwen2-vl and whisper against theirs
(``tests/data/torch_port_golden_families.json``); K5, K6 and the gate
refusing inputs that require grad; and the training gradients of
``loss_fn`` on the card against the CPU's.
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
def test_reduced_families_match_golden_on_the_card():
    """The reduced mixtral, qwen2-vl and whisper: serving through K5 and
    five training steps (no K5) against the JAX package's records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import json

    import chip_smoke

    from repro_torch.kernels.flash_attn.flash_attn import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    before = flash_attention.launches
    for rec in json.loads(chip_smoke.GOLDEN_FAMILIES.read_text())["records"]:
        chip_smoke.family_golden_check(rec, torch.device("cuda", 0))
    assert flash_attention.launches > before


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


@pytest.mark.cuda
def test_ssm_gate_matches_plain_on_the_card():
    """The Mamba2 gate kernel against the plain chain: at zamba2-1.2b's
    shapes (one 4,096-token row block, d_inner 4,096, 64 heads, x and z
    read in place from the projection) within one bfloat16 step of every
    element, and on the float32 route and the other configurations'
    shapes (``chip_smoke.ssm_gate_check``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    assert chip_smoke.ssm_gate_check(torch.device("cuda", 0), time_it=False) < 1e-3


@pytest.mark.cuda
def test_lm_kernels_refuse_inputs_that_require_grad():
    """K5, K6 and the Mamba2 gate have no backward: on the card they raise
    on an input that requires grad (their output would cut the graph) and
    run under ``torch.no_grad``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    chip_smoke.guard_checks(torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_780m", "zamba2_1p2b"])
def test_training_gradients_on_the_card_equal_the_cpus(arch):
    """``loss_fn``'s gradients of the reduced config on the card against
    the port's on the CPU (float32, TF32 off), with no K5 or K6 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    from repro_torch.kernels.flash_attn.flash_attn import flash_attention
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    before = (flash_attention.launches, ssd_scan.launches)
    chip_smoke.train_grads_card_vs_cpu(torch.device("cuda", 0), arch)
    assert (flash_attention.launches, ssd_scan.launches) == before
