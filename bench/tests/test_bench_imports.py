"""Nothing the benchmark runs loads JAX or the JAX package: after the
harness, the reference, the program adapter, every metric reader and the
program's serving path are imported, in a fresh process, no module's
top-level name is exactly ``jax``, ``jaxlib``, ``flax`` or ``repro``."""
import subprocess
import sys

from _small import ROOT

PROBE = r"""
import sys
from bench import run
from bench.readers import reader
from bench import check, control, energy, loop, profile, readers, roofline, traffic
from bench.program import moe_transformer as program
from bench.reference import moe_transformer as reference
for path in sorted((run.BENCH / "metrics").glob("*.py")):
    reader(path.stem)
import repro_torch.serve.engine, repro_torch.models
print(" ".join(run.forbidden_modules()) or "none")
"""


def test_no_jax_or_repro_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "none", out.stdout


def test_forbidden_names_are_compared_whole():
    from bench import run
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        sys.modules.pop("repro", None)
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro.sub"] = sys
        assert "repro" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
