"""BENCHMARK.json and the files it names: a cell's configuration, traffic
and metrics, found by name, and the contract's character rules. A
configuration names its driver (``"system"``: ``systems/<name>.py``), its
step comparison (``"step_check"``: ``checks/<name>.py``) and its ATE
alignment (``"ate_align"``: a key of ``arith.ALIGNMENTS``)."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

from perfbench.core import arith

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(s) -> bool:
    return isinstance(s, str) and NAME_RE.fullmatch(s) is not None


def valid_unit(s) -> bool:
    return isinstance(s, str) and UNIT_RE.fullmatch(s) is not None


def valid_text(s) -> bool:
    """A why, a layer, a source, a word of the command: 1 to 200
    characters on one line, no tab."""
    return (isinstance(s, str) and 1 <= len(s) <= 200
            and not any(c in s for c in "\n\r\t"))


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of `workloads` with everything it names loaded."""

    def __init__(self, name: str, manifest: dict = None):
        m = manifest if manifest is not None else load()
        work = {w["name"]: w for w in m["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(work)})")
        self.name = name
        self.workload = work[name]
        self.chips = int(self.workload["chips"])
        conf = {c["name"]: c for c in m["configs"]}[self.workload["config"]]
        self.config_entry = conf
        self.config = _load_json(conf["file"])
        load_check(self.config)
        ate_align(self.config)
        with open(traffic_path(self.workload["traffic"])) as f:
            self.traffic = json.load(f)
        e2e = [x for x in m["end_to_end"] if applies(x, name)]
        self.end_to_end = e2e
        moved = {x["name"] for x in e2e}
        self.per_layer = [x for x in m["per_layer"]
                          if x["moves"] in moved and applies(x, name)]


def load_reader(name: str):
    """The `read(record)` function of metrics/<name>.py."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_system(name: str):
    """The driver module systems/<name>.py."""
    return importlib.import_module(f"perfbench.systems.{name}")



class ConfigError(ValueError):
    """A configuration that names no known part for a required key."""


CHECK_FUNCTIONS = ("take_state", "keep_out", "compare")


def load_check(config: dict):
    """The step comparison checks/<name>.py that the configuration names
    under ``"step_check"``; no default."""
    name = config.get("step_check")
    if not valid_name(name) or "." in name:
        raise ConfigError(f"the configuration's key 'step_check' names no "
                          f"step comparison (it holds {name!r})")
    module = f"perfbench.checks.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ConfigError(f"the configuration's key 'step_check' names "
                          f"{name!r}, and perfbench/checks/ has no such "
                          "comparison") from None
    lacks = [f for f in CHECK_FUNCTIONS if not callable(getattr(mod, f, None))]
    if lacks:
        raise ConfigError(f"the configuration's key 'step_check' names "
                          f"{name!r}, which lacks {lacks}")
    return mod


def ate_align(config: dict):
    """The ATE over a prefix under the alignment the configuration names
    under ``"ate_align"``; no default."""
    name = config.get("ate_align")
    if not isinstance(name, str) or name not in arith.ALIGNMENTS:
        raise ConfigError(f"the configuration's key 'ate_align' holds "
                          f"{name!r}, not one of {sorted(arith.ALIGNMENTS)}")
    return arith.ALIGNMENTS[name]
