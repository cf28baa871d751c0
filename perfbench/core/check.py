"""What decides ``correct``: the parts every step comparison shares.

At calls of the window drawn from the seed, a ``CallRecorder`` keeps what
the configuration's step comparison (``perfbench/checks/<step_check>.py``,
named under ``"step_check"``) picks out of the timed path's own frame
step: the program's state the call was handed and what it returned. Once
the window has closed and the program is released, that comparison's
``compare`` judges every kept call against its plain reference
(``perfbench/reference``) and adds its numbers to a ``Readings``.

The run as a whole, against the generator's exact ground truth, whatever
the step:

- ``frames_without_pose``: frames handed in, in the window or in the
  prefix that ATE is taken over, for which the system returned no pose
  (limit 0);
- ``stream_ate_m``: the worst stream's ATE over the prefix, under the
  configuration's ``"ate_align"`` (``core/arith.py``).

Each number is compared against its limit in the configuration's
``limits``.
"""

from __future__ import annotations

import contextlib

import torch


class CallRecorder:
    """Wraps `obj.attr`, the frame step. Armed with a tag (the frame
    index), the next call's state is kept before it runs and its output
    after, by the step comparison's `take_state(args, kwargs)` and
    `keep_out(out)`; each kept call is (tag, state, output)."""

    def __init__(self, obj, attr, take_state, keep_out):
        self.orig = getattr(obj, attr)
        self.take_state = take_state
        self.keep_out = keep_out
        self.tag = None
        self.samples = []
        setattr(obj, attr, self)

    def arm(self, tag):
        self.tag = tag

    def __call__(self, *args, **kwargs):
        if self.tag is None:
            return self.orig(*args, **kwargs)
        tag, self.tag = self.tag, None
        state = self.take_state(args, kwargs)
        out = self.orig(*args, **kwargs)
        self.samples.append((tag, state, self.keep_out(out)))
        return out


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmul precision: TF32 off (the configuration's float32), or TF32
    allowed for the control."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def pose_gap(R_a, t_a, R_b, t_b) -> float:
    return float(max((R_a.double() - R_b.double()).abs().max(),
                     (t_a.double() - t_b.double()).abs().max()))


class Readings:
    """Numbers read by the comparisons, each compared against its limit
    in the configuration's ``limits``. ``correct`` when every one is
    within its limit and nothing that had to be checked is missing."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values = {}
        self.missing = []
        self.gaps = []  # every checked pose's gap, for the record

    def worst(self, name, value):
        v = float(value)
        self.values[name] = max(self.values.get(name, v), v)

    def add(self, name, value):
        self.values[name] = self.values.get(name, 0.0) + float(value)

    @property
    def correct(self) -> bool:
        return not self.missing and all(
            self.values.get(k, float("inf")) <= lim
            for k, lim in self.limits.items())

    def lines(self):
        out = [f"check {k}: {self.values.get(k, 'missing')} (limit {lim})"
               for k, lim in self.limits.items()]
        out += [f"check missing: {m}" for m in self.missing]
        return out

    def result(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": lim}
                for k, lim in self.limits.items()}
