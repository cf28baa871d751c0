"""The control on the card, at the cell's own size: the reference
computed in float32 with TF32 allowed (the precision below the
configuration's float32 with TF32 off), put in the program's place, fails
a number that the program passes. On the
card: ``python3 -m pytest perfbench/tests/test_perfbench_control.py``."""

import pytest
import torch

from perfbench.core import harness, manifest

SEED = 3000000999


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read on the card")
    out = harness.execute(cell, SEED, 12.0, False, device="cuda",
                          control=True)
    limits = out["readings"].limits
    assert out["result"]["correct"], out["lines"]
    ctl = out["control"].values
    assert any(ctl.get(k, 0.0) > lim for k, lim in limits.items()), ctl
