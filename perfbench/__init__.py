"""The benchmark of scavislam_tpu_torch on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name: its
configuration in ``configs/<config>.json`` (with the driver that runs it,
``systems/<system>.py``, the comparison of its frame step that decides
``correct``, ``checks/<step_check>.py``, and its ATE alignment,
``ate_align``), its traffic in ``traffic/<mix>.json`` (read by the one
generator, ``core/traffic.py``), and each per-layer metric in
``metrics/<metric>.py``. ``reference/`` is the plain reference the
comparisons hold the program to; ``gen/`` the frozen input renderer.
"""
