"""What a run may load: no module whose top-level name is jax, jaxlib,
flax or scavislam_tpu (compared whole: scavislam_tpu_torch begins with
scavislam_tpu); the plain reference and the generator load nothing of the
port; nothing under perfbench reads bench.py or benchmarks/."""

import subprocess
import sys

from perfbench.core import manifest
from perfbench.core.harness import forbidden_modules


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["scavislam_tpu_torch",
                              "scavislam_tpu_torch.models.frontend",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["scavislam_tpu.models", "jaxlib.xla_client",
                              "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "scavislam_tpu"]


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=manifest.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_and_generator_load_nothing_of_the_port():
    tops = _loaded_after(
        "import perfbench.core.check, perfbench.core.traffic, "
        "perfbench.reference.frame, perfbench.reference.stereo_bm")
    assert not tops & {"scavislam_tpu_torch", "scavislam_tpu", "jax",
                       "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    """The harness and the port's entry points, as a run imports them."""
    tops = _loaded_after(
        "import perfbench.core.harness\n"
        "import scavislam_tpu_torch.pipeline.slam_system\n"
        "import scavislam_tpu_torch.parallel.stream_pool\n"
        "from perfbench.core import manifest\n"
        "[manifest.load_reader(m['name']) for m in "
        "manifest.load()['per_layer']]\n"
        "[manifest.load_system(s) for s in ('slam_system', 'stream_pool')]")
    assert forbidden_modules(tops) == []


def test_nothing_reads_the_jax_benchmark():
    for path in manifest.BENCH_DIR.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "bench.py" not in text and "benchmarks/" not in text, path
