"""Faults planted in the timed path, under the recorder, to see the
comparison that decides ``correct`` come out false: each wraps the
program's frame step (the driver's ``step_site``: the single stream's
step, or the pool's tick with a leading stream axis) and changes what it
returns, given the state the step was handed as the configuration's step
comparison takes it (``take_state``). ``plant(name)`` gives a
``program_hook`` for ``harness.execute``."""

from __future__ import annotations

import torch


def _with_pose(out, R, t):
    """`out` returning pose (R, t), in its device outputs and in the packed
    vector the host policy reads (R at 0:9, t at 9:12)."""
    lead = R.shape[:-2]
    packed = torch.cat([R.reshape(*lead, 9), t, out.packed[..., 12:]], -1)
    return out._replace(R_cw=R, t_cw=t, packed=packed)


def state_unchanged(out, state):
    """Every step returns the pose it was handed."""
    return _with_pose(out, state["R"], state["t"])


def answer_altered(out, state):
    """The disparity altered where it is produced."""
    return out._replace(disp=torch.where(out.disp > 0, out.disp + 0.25,
                                         out.disp))


def half_batch(out, state):
    """Half of the pool's streams left out of the tick's program: their
    lanes come back as they went in."""
    R, t = state["R"], state["t"]
    h = R.shape[0] // 2
    return _with_pose(out, torch.cat([out.R_cw[:h], R[h:]]),
                      torch.cat([out.t_cw[:h], t[h:]]))


def one_lane(out, state):
    """The pool's last stream comes back as it went in."""
    R, t = state["R"], state["t"]
    return _with_pose(out, torch.cat([out.R_cw[:-1], R[-1:]]),
                      torch.cat([out.t_cw[:-1], t[-1:]]))


def pose_lost(out, state):
    """The host is handed a non-finite pose: it drops every frame as lost
    while the device's pose chain goes on."""
    packed = out.packed.clone()
    packed[..., 9:12] = float("nan")
    return out._replace(packed=packed)


FAULTS = {f.__name__: f for f in (state_unchanged, answer_altered,
                                  half_batch, one_lane, pose_lost)}


def plant(name: str, before=None):
    """A program hook that wraps the driver's frame step with fault
    `name`; `before(driver)` runs first (the tests pick the pool's
    route)."""
    fault = FAULTS[name]

    def hook(driver):
        if before is not None:
            before(driver)
        owner, attr = driver.step_site
        orig = getattr(owner, attr)
        take_state = driver.check.take_state

        def broken(*args, **kwargs):
            state = take_state(args, kwargs)
            return fault(orig(*args, **kwargs), state)

        setattr(owner, attr, broken)
    return hook
