"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU runs.

An AST scan of every module of ``src/repro_torch`` and of ``chip_smoke.py``
finds no import of ``jax``/``jaxlib`` or of the ``repro`` package, and a
fresh interpreter that imports the serve and train paths loads neither.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            head = arg.value if isinstance(arg, ast.Constant) else getattr(arg.values[0], "value", "")
            names.add(str(head).rstrip("."))
    return names


def test_scan_covers_the_package():
    rel = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/launch/serve.py" in rel
    assert "src/repro_torch/core/serialize.py" in rel
    assert "src/repro_torch/models/moe.py" in rel
    assert "src/repro_torch/models/whisper.py" in rel
    assert len(FILES) > 40


def test_scan_covers_the_distribution_layer():
    rel = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("distributed/compression.py", "distributed/sharding.py", "launch/mesh.py",
                "launch/specs.py", "launch/dryrun.py", "launch/op_analysis.py"):
        assert f"src/repro_torch/{mod}" in rel, mod


def test_importing_the_dry_run_creates_no_process_group():
    """The reference sets ``XLA_FLAGS`` when its dry-run is imported; the
    port sets up its fake process group only inside ``run_cell``."""
    code = (
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.specs, repro_torch.launch.mesh\n"
        "import repro_torch.launch.op_analysis, repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.compression\n"
        "print(dist.is_initialized())\n"
    )
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in BANNED}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_serve_path_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.api, repro_torch.bridge\n"
        "import repro_torch.launch.train, repro_torch.train\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
    )
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_serve_without_device_raises_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.serve import parse_args, serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(parse_args(["--smoke"]))


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
