"""The port's ground-truth trajectories against the JAX package's: every
kind's poses within 1e-6."""

import numpy as np
import pytest

from scavislam_tpu.io.synthetic import make_trajectory as j_make
from scavislam_tpu_torch.io.synthetic import make_trajectory as t_make

KINDS = ("forward_arc", "orbit", "out_and_back", "spin", "wander", "still")


@pytest.mark.parametrize("kind", KINDS)
def test_trajectory_matches_jax(kind):
    n, step = 37, 1.0 / 36
    for Tt, Tj in zip(t_make(n, kind, step), j_make(n, kind, step)):
        np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-6)
        np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=1e-6)


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        t_make(3, "teleport")
