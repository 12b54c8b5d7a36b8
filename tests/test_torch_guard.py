"""The port stands alone: no file of ``src/repro_torch/``, no
``examples/*_torch.py`` and not ``chip_smoke.py`` imports JAX, the
reference package ``repro`` or ``ml_dtypes`` (the card's machine has none),
importing ``repro_torch`` pulls none of them into the process, and the
package's modules import in any order (no import cycle)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
         + sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"])


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


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
            "repro_torch.models.mla, repro_torch.configs.deepseek_v3_671b, "
            "repro_torch.launch.serve, repro_torch.models.registry, "
            "repro_torch.weights, repro_torch.models.ssd, repro_torch.models.rglru, "
            "repro_torch.models.encdec, repro_torch.core.baselines, "
            "repro_torch.configs.mamba2_370m, repro_torch.configs.recurrentgemma_2b, "
            "repro_torch.configs.whisper_medium, repro_torch.configs.pixtral_12b, "
            "repro_torch.optim, repro_torch.optim.adamw, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.checkpoint, "
            "repro_torch.checkpoint.manager, repro_torch.runtime.fault_tolerance, "
            "repro_torch.runtime.straggler, repro_torch.launch.train, "
            "repro_torch.core, repro_torch.runtime, repro_torch.sharding; "
            "from repro_torch.runtime import StemEngine; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("first", ["repro_torch.core", "repro_torch.kernels.paged_attn"])
def test_import_first_in_fresh_process(first):
    """``repro_torch.core`` (whose modules import the kernel wrappers) and
    ``repro_torch.kernels.paged_attn`` (which imports core's stages) each
    import first in a fresh process, and the package exports resolve; no
    import builds a kernel (the build stays at first use)."""
    code = (f"import sys, {first}; import repro_torch.core as c; "
            "from repro_torch.core import StemConfig, stem_attention, schedule_for; "
            "from repro_torch.kernels import _build, paged_attn; "
            "assert c.TopKSelector and paged_attn.score_pages; "
            "print(sorted(_build._LIBS)); sys.exit(1 if _build._LIBS else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
