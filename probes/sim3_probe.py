"""The one-time and steady costs of the mono Sim3 path on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 probes/sim3_probe.py

Each line is the wall time of one call, first and second in a fresh
process (synchronized before and after), in this order:
``optimize_sim3_pose_graph`` on a two-node graph (12 iterations, the size
of a first loop closure), ``Sim3.log`` under forward-mode AD on a batch of
28 (its closed-form 3x3 inverse), and the forward-mode derivative of a
batched 3x3 ``torch.linalg.solve_ex`` (the library solve ``Sim3.log``
does not use). The last line is the card's name and power
limit as nvidia-smi reports them; no check fails the run.
"""

import os
import subprocess
import sys
import time

import torch
import torch.autograd.forward_ad as fwAD

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from scavislam_tpu_torch.core.lie import Sim3  # noqa: E402
from scavislam_tpu_torch.models.sim3_graph import (  # noqa: E402
    optimize_sim3_pose_graph,
)


def timed(label, fn):
    for run in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"{label}, {run} call: "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    (torch.ones(3, device=dev) + 1).cpu()  # the context, outside the timing
    W = (torch.eye(3, device=dev).repeat(28, 1, 1)
         + 0.01 * torch.randn(28, 3, 3, device=dev, generator=gen))
    b = torch.randn(28, 3, 1, device=dev, generator=gen)
    tangent = torch.randn(28, 3, 3, device=dev, generator=gen)

    def solve_fw():
        with fwAD.dual_level():
            x = torch.linalg.solve_ex(fwAD.make_dual(W, tangent), b)[0]
            fwAD.unpack_dual(x)

    S = Sim3.exp(0.1 * torch.randn(28, 7, device=dev, generator=gen))
    xi = torch.randn(28, 7, device=dev, generator=gen)

    def log_fw():
        with fwAD.dual_level():
            e = fwAD.make_dual(torch.zeros_like(xi), xi)
            fwAD.unpack_dual((Sim3.exp(e) @ S).log())

    nodes = Sim3.exp(0.1 * torch.randn(2, 7, device=dev, generator=gen))
    meas = Sim3.exp(0.1 * torch.randn(2, 7, device=dev, generator=gen))

    def graph():
        optimize_sim3_pose_graph(
            nodes, torch.tensor([0, 1], device=dev),
            torch.tensor([1, 0], device=dev), meas,
            torch.ones(2, dtype=torch.bool, device=dev), iters=12)

    # the user's path first, so that it pays whatever set-up it needs
    timed("optimize_sim3_pose_graph, 2 nodes, 12 iterations", graph)
    timed("forward-mode Sim3.log, 28 elements", log_fw)
    timed("forward-mode solve_ex, 28 3x3 systems", solve_fw)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
