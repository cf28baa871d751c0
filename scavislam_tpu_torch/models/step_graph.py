"""The stereo frame step replayed as a CUDA graph: the port's counterpart
of the twin's ``jax.jit`` of ``models.frontend_step.frontend_step``, and
the same for the backend's two programs (its solve and its registration)
and the multistream steps' batched programs
(``parallel.multistream.OverDp``: the batched block-matching call and the
vmapped step of a pool tick in one graph), which the twin jits too.

The step makes no host read (its two LMs are fixed-trip device loops, the
active keyframe is a device scalar), so one frame's tens of thousands of
kernel launches can be captured once and replayed. ``GraphedFn(fn)`` holds
one ``torch.cuda.CUDAGraph`` of ``fn`` per static key: the shapes, dtypes
and devices of the tensor arguments and the values of every other
argument (for the step: the stack's 2 uint8 planes, or 3 f32 planes with
an external disparity; the table, cloud and candidate capacities; the
camera floats, levels, disparities, stereo method and options, the
reprojection bound, the dense subsampling and sampler).

- Capture. The first call with a key runs ``fn`` eagerly on a side stream
  (the warm-up that ``torch.cuda.graphs`` asks for: it builds and loads
  the block-matching library and every library handle; its result is that
  call's result), then captures ``fn`` on static copies of the tensor
  arguments with ``capture_error_mode="thread_local"``: the other threads
  keep launching on their own streams meanwhile.
- Inputs. Before a replay each tensor argument is copied into its static
  buffer unless it is the very tensor copied last time, at the same
  ``_version``: the point and pose tables change only at keyframes and
  adoptions, and every path that replaces a table or the dense state
  hands in a new tensor, which is copied.
- Outputs. Each replay's outputs are cloned, so that a result stays valid
  past the next replay, as an eager call's does (pipelining, keyframe
  images, the debug state, the spawn).
- Launch counts. A counted kernel wrapper (``ops.stereo_bm``) called
  during the capture records its kernels without launching them, so it
  notes the call in ``stereo_bm.CAPTURED`` (per thread) instead of
  counting it; every replay counts those calls.

Why the backend's programs are graphs too: one replay of the frame step
submits its tens of thousands of kernels in one driver call, which holds
off every other thread's launches for about as long as the card takes to
run them, so an eager solve or registration on the backend's thread
(hundreds to ~18,000 launches) waits behind the frame loop for seconds. A
graph replay waits once.

There is no fallback: a failed capture or replay raises. The CPU has no
graphs; the callers run ``fn`` directly there.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from scavislam_tpu_torch.models.frontend_step import frontend_step
from scavislam_tpu_torch.ops import stereo_bm

def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class _Captured:
    """One captured call: the graph, its static tensor inputs and outputs,
    and the counted wrappers its capture recorded."""

    def __init__(self, graph, static_in, static_out, recorded):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.recorded = recorded
        # (tensor, _version) last copied into each static input
        self.loaded = [None] * len(static_in)

    def load(self, tensors):
        for i, (buf, x) in enumerate(zip(self.static_in, tensors)):
            last = self.loaded[i]
            if last is not None and last[0] is x and last[1] == x._version:
                continue
            buf.copy_(x)
            self.loaded[i] = (x, x._version)

    def replay(self, tensors):
        self.load(tensors)
        self.graph.replay()
        for wrapper in self.recorded:
            wrapper.launches += 1
        return pytree.tree_map(_clone, self.static_out)


class GraphedFn:
    """`fn` (whose tensors are all on one CUDA device) run as CUDA graph
    replays, one graph per static key. ``captures`` and ``replays`` count
    what it did."""

    def __init__(self, fn):
        self.fn = fn
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *args, **kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        is_t = [isinstance(x, torch.Tensor) for x in leaves]
        tensors = [x for x, t in zip(leaves, is_t) if t]
        if not tensors or not all(x.is_cuda for x in tensors):
            raise TypeError("a CUDA graph runs on CUDA tensors only")
        key = (str(spec), tuple(
            (tuple(x.shape), x.dtype, x.device) if t else x
            for x, t in zip(leaves, is_t)))

        def call(flat):
            it = iter(flat)
            a, k = pytree.tree_unflatten(
                [next(it) if t else x for x, t in zip(leaves, is_t)], spec)
            return self.fn(*a, **k)

        with torch.cuda.device(tensors[0].device):
            captured = self._graphs.get(key)
            if captured is None:
                out, self._graphs[key] = _capture(call, tensors)
                self.captures += 1
                return out
            self.replays += 1
            return captured.replay(tensors)


def _capture(call, tensors):
    """(the warm-up's result, the captured call)."""
    dev = tensors[0].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = call(tensors)
    cur.wait_stream(side)
    for x in pytree.tree_leaves(out):
        if isinstance(x, torch.Tensor):
            x.record_stream(cur)  # allocated on the side stream, used here
    static_in = [x.clone() for x in tensors]
    graph = torch.cuda.CUDAGraph()
    stereo_bm.CAPTURED.calls = recorded = []
    try:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            static_out = call(static_in)
    finally:
        stereo_bm.CAPTURED.calls = None
    captured = _Captured(graph, static_in, static_out, recorded)
    captured.loaded = [(x, x._version) for x in tensors]
    return out, captured


class StepGraph(GraphedFn):
    """``frontend_step`` as CUDA graph replays (``frontend_step``'s
    signature). The active keyframe must be a device scalar: a host int
    would be a static argument, one graph per keyframe."""

    def __init__(self):
        super().__init__(frontend_step)

    def __call__(self, *args, **kwargs):
        if not isinstance(args[7], torch.Tensor):
            raise TypeError("StepGraph takes the active keyframe as a "
                            "device scalar")
        return super().__call__(*args, **kwargs)
