"""The port's training launcher end to end on the CPU, beside the JAX
package's (``tests/test_train_loop.py``'s cell: the reduced smollm, batch
4 x 64).

The port's ``main(..., device="cpu")``: the loss falls over 20 steps, and a
second run resumes from step 20 to 25.  Cross-package resume, both ways:
one launcher writes its checkpoint at step 10, the other resumes from it
to step 15, and its losses at steps 10-14 equal those of the writer's own
resume from a copy of the same directory to ``rtol=1e-5`` (float32; the
two packages sum in other orders).
"""
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.launch.train import main as j_train_main

from repro_torch.launch.train import main as train_main

ARGS = ["--arch", "smollm_360m", "--reduced", "--batch", "4", "--seq", "64",
        "--ckpt-every", "10", "--log-every", "50"]


def port(argv):
    return train_main(argv, device="cpu")


def test_loss_decreases_and_resumes(tmp_path):
    args = ARGS + ["--ckpt-dir", str(tmp_path / "ckpt")]
    losses = port(args + ["--steps", "20"])
    assert len(losses) == 20
    assert losses[-1] < losses[0]
    losses2 = port(args + ["--steps", "25"])
    assert len(losses2) == 5  # resumed, not restarted
    assert np.isfinite(losses2).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume(tmp_path, writer):
    """The checkpoint of step 10, written by ``writer``, resumed to 15 by
    both launchers."""
    run = {"jax": j_train_main, "port": port}
    reader = "port" if writer == "jax" else "jax"
    own, other = str(tmp_path / "own"), str(tmp_path / "other")
    run[writer](ARGS + ["--ckpt-dir", own, "--steps", "10"])
    shutil.copytree(own, other)
    ref = run[writer](ARGS + ["--ckpt-dir", own, "--steps", "15"])
    got = run[reader](ARGS + ["--ckpt-dir", other, "--steps", "15"])
    assert len(ref) == len(got) == 5
    np.testing.assert_allclose(got, ref, rtol=1e-5)
