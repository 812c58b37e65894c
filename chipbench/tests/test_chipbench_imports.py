"""A run loads no module of JAX or of the JAX package ``repro`` (whole
top-level names: ``repro_torch`` is the port), and the reference imports
nothing of ``repro_torch`` either."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level(code: str) -> set[str]:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{REPO}:{REPO / 'src'}"}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(res.stdout.split())


def test_reference_imports_no_port_and_no_jax():
    """Every family and reference file the benchmark has, and those of the
    tests' data, loaded by path as the harness loads them."""
    mods = _top_level("""
        import sys
        from pathlib import Path
        from chipbench import registry
        roots = [Path("chipbench"), *sorted(Path("chipbench/tests/data").iterdir())]
        load = {"families": registry.family, "reference": registry.reference}
        found = [(folder, p.stem, root) for root in roots for folder in load
                 for p in sorted((root / folder).glob("*.py")) if p.name != "__init__.py"]
        assert {name for _, name, _ in found} >= {"dense", "hybrid", "moe"}, found
        for folder, name, root in found:
            load[folder](name, root)
        import chipbench.reference.common, chipbench.check
        print(" ".join({m.split(".", 1)[0] for m in sys.modules}))
    """)
    assert not mods & (FORBIDDEN | {"repro_torch"}), mods & (FORBIDDEN | {"repro_torch"})


def test_a_smoke_run_loads_no_jax(tmp_path):
    """A tiny cell, run end to end on the CPU, traced, in a fresh process."""
    mods = _top_level(f"""
        import shutil, sys, torch
        from pathlib import Path
        sys.path.insert(0, {str(REPO / 'chipbench' / 'tests')!r})
        from conftest import add_tiny_cells
        root = Path({str(tmp_path)!r}) / "chipbench"
        shutil.copytree({str(REPO / 'chipbench')!r}, root,
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        shutil.copy({str(REPO / 'BENCHMARK.json')!r}, root.parent / "BENCHMARK.json")
        cells = add_tiny_cells(root)
        from chipbench import run
        for cell in cells:
            out = run.run_cell(cell, 3, 0.5, True, torch.device("cpu"), root=root)
            assert out["correct"], out
        print(" ".join({{m.split(".", 1)[0] for m in sys.modules}}))
        print(" ".join(run.forbidden_modules()) or "none-forbidden")
    """)
    assert "repro_torch" in mods and "none-forbidden" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from chipbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()
