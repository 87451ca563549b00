"""The check fails what it should.  A whole run of each cell (on the CPU at
small sizes, the look for a card skipped) with the timed path broken
underneath comes out not correct, once for each fault a prefill cell can
have: a step that returns its state unchanged (the cache as it was before
the step: zeros), half of the batch left out with the mean over the rest
in its place, and the served token altered where it is produced.  (The
exchange between chips does not exist on one chip.)  The same run
unbroken comes out correct, and the control, the reference in the
program's place with float8 products, comes out not correct.  Each cell
whose configuration has a CPU cut (``tiny_cuts/<config>.json``) is taken."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import bench, check
from perfbench.tests.tiny import TINY, tiny_cells, tiny_root

CELLS = tiny_cells()  # every cell whose configuration has a CPU cut
FAULTS = ["sound", "state_unchanged", "half_batch", "token_altered"]


def broken(fault: str, family: str, cfg: dict):
    from repro_torch.launch.steps import make_prefill_step

    def factory(model_cfg):
        step = make_prefill_step(model_cfg)

        def prefill(model, batch):
            logits, cache = step(model, batch)
            parts = check.program_parts(family, cfg, cache).values()
            if fault == "state_unchanged":
                for t in parts:
                    t.zero_()
            elif fault == "half_batch":
                h = logits.shape[0] // 2
                for t in list(parts) + [logits]:
                    t[h:] = t[:h].mean(dim=0)
            elif fault == "token_altered":  # each request's best logit swapped with its worst
                v = cfg["vocab_size"]
                for row in logits[:, :v]:
                    hi, lo = int(row.argmax()), int(row.argmin())
                    row[hi], row[lo] = row[lo].clone(), row[hi].clone()
            return logits, cache

        return prefill

    return factory


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("faults"))
    for name in TINY:  # float32: the sound program then reads near zero
        path = root / "perfbench" / "configs" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), dtype="float32",
                                        param_dtype="float32")))
    return root


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_step_is_not_correct(root, cell_name, fault):
    cell = bench.load_cell(cell_name, root)
    factory = None if fault == "sound" else broken(fault, cell.family, cell.config)
    out = bench.run_cell(cell, 2**31 + 77, 0.3, False, torch.device("cpu"), 0.0,
                         step_factory=factory, log=lambda m: None)
    assert out["correct"] is (fault == "sound"), out["compared"]
    assert set(out["compared"]) == set(cell.spec["limits"])


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(tmp_path, cell_name):
    root = tiny_root(tmp_path)  # the configurations' own bfloat16
    cell = bench.load_cell(cell_name, root)
    values = cell.kind.readings(cell, 2**31 + 91, "control", torch.device("cpu"))
    ok, rows = check.judge(values, cell.spec["limits"])
    assert not ok, rows
