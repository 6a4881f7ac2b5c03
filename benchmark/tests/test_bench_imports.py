"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module name (``video3d_tpu_torch`` begins with ``video3d_tpu``),
and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

from benchmark.harness.registry import BENCH_DIR, ROOT

TOP_LEVEL = """
import json, sys
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_after(body: str, cwd) -> set:
    out = subprocess.run([sys.executable, "-c", TOP_LEVEL.format(body=body)],
                         cwd=cwd, capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(cwd),
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    """Every module a whole tiny run loads (harness, program, reference)."""
    body = (
        "from pathlib import Path\n"
        "from benchmark.harness.registry import Registry\n"
        "from benchmark.harness import cell\n"
        f"root = Path({str(tiny_root)!r})\n"
        "reg = Registry(root, root / 'benchmark')\n"
        "cell.run(reg, 'tiny_hybrid', 3, 3.0, False, 'cpu', log=lambda m: 0)\n"
    )
    names = _top_level_after(body, tiny_root)
    assert "video3d_tpu_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "video3d_tpu"}


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    names = _top_level_after("import benchmark.reference.depth", tmp_path)
    assert not names & {"jax", "jaxlib", "flax", "video3d_tpu",
                        "video3d_tpu_torch"}


def test_no_source_imports_jax():
    """The import statements of every file of the benchmark."""
    bad = {"jax", "jaxlib", "flax", "video3d_tpu"}
    for path in BENCH_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert not tops & bad, (path, tops)
            if path.parent.name == "reference":
                assert "video3d_tpu_torch" not in tops, path


def test_run_guard_compares_whole_names(monkeypatch):
    from benchmark import run

    assert "video3d_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "video3d_tpu_torch_extra",
                        types.ModuleType("video3d_tpu_torch_extra"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "video3d_tpu.stages",
                        types.ModuleType("video3d_tpu.stages"))
    assert run.forbidden_modules() == ["video3d_tpu"]


def test_run_refuses_without_a_card(capsys):
    import torch

    from benchmark import run

    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "stereo_hsbs", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
