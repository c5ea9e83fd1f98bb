"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program: top-level module names
compared whole, since ``se2lam_tpu_torch`` begins with ``se2lam_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "se2lam_tpu"}


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


HARNESS = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(BENCH)))
def test_harness_imports_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"se2lam_tpu_torch", "portbench"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.delitem(sys.modules, "se2lam_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "se2lam_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "se2lam_tpu_torch_extra", object())
    assert "se2lam_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "se2lam_tpu.frontend", object())
    assert "se2lam_tpu" in bench.forbidden_modules()


def test_a_run_loads_no_jax():
    """Every module of the harness and the program it drives, imported in a
    fresh process, loads none of JAX."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.bench, portbench.control, portbench.trace\n"
            "import portbench.systems.slam, portbench.systems.localizer\n"
            "import se2lam_tpu_torch.system, se2lam_tpu_torch.localizer, se2lam_tpu_torch.io\n"
            "from portbench.bench import Manifest, forbidden_modules\n"
            "m = Manifest()\n"
            "[m.reader(x['name']) for x in m.doc['per_layer']]\n"
            "print(forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_a_machine_without_a_card():
    """On this CPU machine the command prints no result and exits nonzero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "room640_loc.route",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
