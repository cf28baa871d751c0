"""The control of ``correct``, and the program's readings over many seeds,
in one process, on the card:

    python3 perfbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

For each seed it runs the cell as ``run.py`` does (set-up, a window of
`--seconds`, the kept calls) and prints one JSON line with the numbers
compared for the program against the plain reference (``program``: the
lower readings) and for the reference computed in float32 with TF32
allowed against the same float64 reference (``control``: the upper
readings), with every checked pose's gap. With ``--fault`` the program
runs with that fault planted (``core/faults.py``). The benchmark's own
runs never run it."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    from perfbench.core import faults, harness, manifest

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    a = p.parse_args(argv)
    harness.require_card(manifest.Cell(a.workload).chips)
    hook = faults.plant(a.fault) if a.fault else None
    for seed in a.seeds:
        t = time.perf_counter()
        out = harness.execute(a.workload, seed, a.seconds, False,
                              device="cuda", t0=t, control=a.fault is None,
                              program_hook=hook)
        r = out["result"]
        ctl = out["control"]
        print(json.dumps({
            "workload": a.workload, "seed": seed, "fault": a.fault,
            "program": out["readings"].values,
            "control": ctl.values if ctl else None,
            "gaps": out["readings"].gaps,
            "control_gaps": ctl.gaps if ctl else None,
            "missing": out["readings"].missing,
            "correct": r["correct"],
            "end_to_end": r["window"]["end_to_end"],
            "attempted": r["attempted"], "failed": r["failed"],
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
