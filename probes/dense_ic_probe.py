"""The dense tracker's inverse-compositional evaluation on a CUDA card:
the kernels of ``ops/dense_ic.py`` against the plain PyTorch version at
the benchmark cells' level shapes, and what each costs. Run from the root
of a checkout:

    python3 probes/dense_ic_probe.py

The cases and the numbers of each line are ``probes/dense_ic_cases.py``'s
(``cell_levels``, ``poses``, ``level_line``): per cell, level and pose,
the kernel against the plain version and against the float64 sum of the
plain version's terms, the batched call against per-lane calls, graph
replays, and us a call eager and in a graph of 31 beside the bytes bound.
Per cell and level besides, the whole ``_lm_level_ic`` as a graph replay
with each, and the LM's pose and iterations with each. The last lines are
a JSON record of the numbers and the card's name and power limit.
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from probes import dense_ic_cases as cases  # noqa: E402
from scavislam_tpu_torch.models import dense_tracker  # noqa: E402
from scavislam_tpu_torch.ops import dense_ic  # noqa: E402


def lm_line(cell, lv, level, rec):
    """The whole level's LM from the identity, as a graph replay, with the
    kernel and with the plain version."""
    cam, img, c, i, J, v = level
    B = c.shape[0]
    dev = img.device
    R0, t0 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    plain = dense_tracker._ic_pass

    def run():
        if B == 1:
            return dense_tracker._lm_level_ic(cam, img[0], c[0], i[0], J[0],
                                              v[0], R0, t0)
        with dense_tracker.lanes():
            return torch.func.vmap(
                lambda *a: dense_tracker._lm_level_ic(cam, *a, R0, t0))(
                img, c, i, J, v)

    res = {}
    for name, fn in (("kernel", plain), ("plain", cases.plain_lane)):
        dense_tracker._ic_pass = fn
        try:
            g, o = cases.graph_of(run)
            g.replay()
            torch.cuda.synchronize()
            res[name] = ([x.clone() for x in o],
                         chip_smoke._cuda_ms(g.replay, 10))
        finally:
            dense_tracker._ic_pass = plain
    (ok, mk), (op, mp) = res["kernel"], res["plain"]
    out = {"ms_kernel": mk, "ms_plain": mp,
           "dR": float((ok[0] - op[0]).abs().max()),
           "dt": float((ok[1] - op[1]).abs().max()),
           "chi2_rel": cases.rel(ok[2], op[2]),
           "iters_kernel": ok[3].reshape(-1).tolist(),
           "iters_plain": op[3].reshape(-1).tolist()}
    rec[f"{cell}.L{lv}.lm"] = out
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}",
          flush=True)
    dense_ic._Kernel.load()
    ptx = chip_smoke._ptxas(dense_ic._Kernel.log)
    print(f"build: {dense_ic._Kernel.build_seconds:.2f} s; ptxas "
          + "; ".join(f"{k} {r} registers, {sm} B smem, {sp} B spilled"
                      for k, (r, sm, sp) in sorted(ptx.items())), flush=True)
    rec = {}
    for cell, (streams, subs) in cases.CELLS.items():
        levels = cases.cell_levels(dev, streams, subs)
        for lv in (2, 1, 0):
            for R, t in cases.poses(dev, streams):
                o = cases.level_line(levels[lv], R, t, chip_smoke._cuda_ms)
                rec.setdefault(f"{cell}.L{lv}", []).append(o)
                print(f"{cell} level {lv}: {o['B']} x {o['n']} points "
                      f"(in frame {o['in_frame']}), image {o['image']}; vs "
                      f"plain H b chi2 {[f'{x:.2e}' for x in o['vs_plain']]}; "
                      f"vs f64 {[f'{x:.2e}' for x in o['vs_f64']]}, uv "
                      f"differ {o['uv_differ']}; one point "
                      f"{o['one_point']:.2e}; vmap equal "
                      f"{o.get('vmap_equal')}; graph equal "
                      f"{o['graph_equal']}, captured per replay "
                      f"{o['captured_per_replay']}; us eager kernel "
                      f"{o['us_eager_kernel']:.1f} plain "
                      f"{o['us_eager_plain']:.1f}, in a graph kernel "
                      f"{o['us_graph_kernel']:.2f} plain "
                      f"{o['us_graph_plain']:.1f}, bound "
                      f"{o['bound_us']:.2f}", flush=True)
            o = lm_line(cell, lv, levels[lv], rec)
            print(f"{cell} level {lv} LM (graph replay): ms kernel "
                  f"{o['ms_kernel']:.3f} plain {o['ms_plain']:.3f}; max "
                  f"|dR| {o['dR']:.2e} |dt| {o['dt']:.2e} chi2 rel "
                  f"{o['chi2_rel']:.2e}; iterations {o['iters_kernel']} / "
                  f"{o['iters_plain']}", flush=True)
    print(json.dumps(rec))
    print(smi)


if __name__ == "__main__":
    main()
