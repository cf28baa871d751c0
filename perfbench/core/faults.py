"""Faults planted in the timed path, under the recorder, to see the
comparison that decides ``correct`` come out false: each wraps the
program's frame step (the single stream's, or the pool's tick with a
leading stream axis) and changes what it returns. ``plant(name)`` gives a
``program_hook`` for ``harness.execute``."""

from __future__ import annotations

import torch


def _with_pose(out, R, t):
    """`out` returning pose (R, t), in its device outputs and in the packed
    vector the host policy reads (R at 0:9, t at 9:12)."""
    lead = R.shape[:-2]
    packed = torch.cat([R.reshape(*lead, 9), t, out.packed[..., 12:]], -1)
    return out._replace(R_cw=R, t_cw=t, packed=packed)


def state_unchanged(out, args):
    """Every step returns the pose it was handed."""
    return _with_pose(out, args[5], args[6])


def answer_altered(out, args):
    """The disparity altered where it is produced."""
    return out._replace(disp=torch.where(out.disp > 0, out.disp + 0.25,
                                         out.disp))


def half_batch(out, args):
    """Half of the pool's streams left out of the tick's program: their
    lanes come back as they went in."""
    h = args[5].shape[0] // 2
    return _with_pose(out, torch.cat([out.R_cw[:h], args[5][h:]]),
                      torch.cat([out.t_cw[:h], args[6][h:]]))


def one_lane(out, args):
    """The pool's last stream comes back as it went in."""
    return _with_pose(out, torch.cat([out.R_cw[:-1], args[5][-1:]]),
                      torch.cat([out.t_cw[:-1], args[6][-1:]]))


def pose_lost(out, args):
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
        owner, attr = ((driver.system.frontend, "_step")
                       if hasattr(driver, "system") else (driver.pool, "step"))
        orig = getattr(owner, attr)

        def broken(*args, **kwargs):
            return fault(orig(*args, **kwargs), args)

        setattr(owner, attr, broken)
    return hook
