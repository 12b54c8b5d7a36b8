"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``, and
importing ``repro_torch`` pulls no JAX into the process."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.runtime.engine, "
            "repro_torch.kernels.paged_attn, repro_torch.kernels.block_sparse_attn, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.stem_metric, "
            "repro_torch.core.sparse_attention, repro_torch.launch.steps, "
            "repro_torch.launch.serve, repro_torch.models.registry, "
            "repro_torch.weights; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
