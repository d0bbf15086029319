"""Package rules of the PyTorch port: it stands alone (no JAX, no reference
package), its entry points never drop to the CPU on their own, and its Eq. 1
agrees with the reference's."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.power import DEVICES as JAX_DEVICES
from repro.core.power import power as jax_power
from repro_torch.core.power import DEVICES, power

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_reference():
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import main
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduced_config(get_config("llama3-8b")))
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "llama3-8b", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)


@pytest.mark.parametrize("name", ["h100", "a100", "a40", "tpu-v5e"])
def test_power_matches_reference(name):
    mfu = np.concatenate([np.linspace(-0.1, 1.2, 997), [0.0, 0.45, 1e-7]])
    want = np.asarray(jax_power(mfu, JAX_DEVICES[name]))
    got = power(mfu, DEVICES[name]).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)
