"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, checked on the source
(AST) and by importing the port in a fresh interpreter."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), filename=str(path))))
    assert not roots & FORBIDDEN, f"{path} imports {sorted(roots & FORBIDDEN)}"


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import repro_torch.core.ssa, repro_torch.launch.anneal, repro_torch.convert\n"
        "import repro_torch.core.rng, repro_torch.core.memory, repro_torch.core.distributed\n"
        "import repro_torch.core.ssqa, repro_torch.core.autotune\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ssa_update, repro_torch.kernels.ref\n"
        "import repro_torch.serve, repro_torch.serve.anneal_service, repro_torch.ft.faults\n"
        "import repro_torch.serve.stream, repro_torch.checkpoint.ckpt\n"
        "import repro_torch.benchmarks.serve_stream, repro_torch.benchmarks.chaos\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.serve.lm\n"
        "import repro_torch.examples.serve_lm\n"
        "import repro_torch.train.step, repro_torch.optim.adamw, repro_torch.data.pipeline\n"
        "import repro_torch.ft.resilience, repro_torch.launch.train\n"
        "import repro_torch.examples.train_lm\n"
        "import repro_torch.core.lowering, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.launch.mesh\n"
        "import repro_torch.launch.lowering, repro_torch.launch.dryrun, repro_torch.sharding\n"
        "import repro_torch.models.params, repro_torch.configs.shapes\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
