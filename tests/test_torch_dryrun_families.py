"""The port's dry run on the moe, ssm and encdec families' reduced
configs, in each mode, on a fake (2, 2) device mesh (the checks of
``tests/test_torch_dryrun.py``): the MoE's explicit dispatch and combine
layouts, the SSD scan and states, the encoder and cross-attention, traced
with their inputs laid out by the sharding plan.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import FAMILIES, MODES, check_cell, tiny_cell  # noqa: E402


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", ("moe", "ssm", "encdec"))
def test_reduced_cell_traces_on_a_fake_2x2_mesh(family, mode, tmp_path):
    check_cell(tiny_cell(FAMILIES[family], mode, tmp_path), mode)
