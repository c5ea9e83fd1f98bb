"""Every public name of the JAX package has a counterpart in the port.

Both packages are read as source with ``ast``; neither is imported. For
each module ``se2lam_tpu/<path>.py`` the port's ``se2lam_tpu_torch/<path>.py``
must hold, under the same name:

- each public function and class (a ``def``, a ``class``, an assignment or
  an import of the name);
- each public method of a public class, and each field (an annotated
  class attribute) of a dataclass or named tuple; a JAX ``@property`` may
  be an attribute the port's class assigns (``self.<name> = ...``);
- each public upper-case module constant;
- each parameter of those functions and methods, where a JAX ``key`` or
  ``keys`` is met by a ``generator``, ``gumbel``, ``noise`` or ``draw``
  (torch cannot replay a JAX PRNG stream; the port takes a generator or
  the drawn samples).

Anything else must be on ``EXCLUDED``, each entry with its reason. No
public method of ``SlamSystem``, ``Localizer`` or ``LoopCloser`` may be on
it.
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "se2lam_tpu", ROOT / "se2lam_tpu_torch"
DRAWS = {"generator", "gumbel", "noise", "draw"}

# (module, name) -> why the port has no counterpart of that name
EXCLUDED = {
    ("__init__.py", "enable_compilation_cache"):
        "sets XLA's compilation cache; eager torch compiles nothing",
    ("frontend/orb.py", "OrbConfig.use_pallas_fast"):
        "a TPU lowering switch; the port dispatches on the tensor's device alone",
    ("frontend/orb.py", "make_extractor"):
        "the extractor is the OrbExtractor module",
    ("frontend/matcher.py", "match_by_projection"):
        "the dense projection matcher; K2's plain version computes it, and the port has one "
        "projection matcher (windowed_match.match_by_projection_streamed)",
    ("utils/chunking.py", "pad_chunk"):
        "the port's chunk steps past the live ones are not run, so no padding is needed",
    ("solver/ba.py", "BAConfig.accum"):
        "a lowering switch (scatter or one-hot matmuls); the port's sums are fixed-order "
        "scatter-adds (ops/fixed_order.index_add_)",
    ("solver/ba.py", "accumulate_obs(accum)"):
        "the same switch as a parameter",
    ("solver/ba.py", "PALLAS_SCHUR_MAX_K"):
        "the Pallas kernel's shape limit; K3 on the card has none",
    ("solver/ba.py", "PALLAS_SCHUR_MIN_M"):
        "the smallest M sent to the Pallas kernel; K3 takes every CUDA call",
    ("localmap.py", "insert_and_optimize(prune_rounds)"):
        "the port prunes once an insertion, as the JAX default does",
}
# the Pallas modules: each kernel is CUDA C++ in csrc/, reached through a wrapper
PALLAS = {
    "frontend/pallas_fast.py": ("csrc/fast_nms.cu", "frontend/fast_nms.py",
                                {"fast_nms_pallas": "fast_nms_levels"}),
    "frontend/pallas_match.py": ("csrc/windowed_top2.cu", "frontend/windowed_match.py",
                                 {"windowed_top2": "windowed_top2",
                                  "match_by_projection_streamed":
                                      "match_by_projection_streamed"}),
    "solver/pallas_schur.py": ("csrc/schur_reduce.cu", "solver/schur.py",
                               {"schur_reduce_pallas": "point_reduction"}),
}
# the chunk feed's per-step state: a list of StepFields records with these fields
RECORDS = {("tracking.py", "ChunkSteps"): "StepFields"}
CLASSES_KEPT_WHOLE = ("SlamSystem", "Localizer", "LoopCloser")


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _is_property(fn):
    return any(isinstance(d, ast.Name) and d.id == "property" for d in fn.decorator_list)


def surface(path):
    """{name: kind} of the public names of a module (``Class.name`` for a
    class member, ``fn(param)`` for a parameter), with the assigned
    attributes of each class as ``Class.attr``: kind "attr"."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = "def"
            for p in _params(node):
                out[f"{node.name}({p})"] = "param"
        elif isinstance(node, ast.ClassDef):
            out[node.name] = "class"
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{b.name}"] = "property" if _is_property(b) else "def"
                    for p in _params(b):
                        out[f"{node.name}.{b.name}({p})"] = "param"
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    out[f"{node.name}.{b.target.id}"] = "field"
            for n in ast.walk(node):
                if (isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
                        and isinstance(n.value, ast.Name) and n.value.id == "self"):
                    out.setdefault(f"{node.name}.{n.attr}", "attr")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name):
                    out[t.id] = "const" if t.id.isupper() else "assign"
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], "import")
    return out


def _wanted(kind, name):
    """A public def, class, field, constant or parameter (a constructor's
    parameters too)."""
    parts = re.split(r"[.(]", name.rstrip(")"))
    return (kind not in ("import", "attr", "assign") and parts[-1] != "__init__"
            and not any(p.startswith("_") and p != "__init__" for p in parts))


def _missing(rel):
    want = surface(JAX_PKG / rel)
    have = surface(PORT_PKG / rel)
    out = []
    for name, kind in want.items():
        if not _wanted(kind, name) or name in have:
            continue
        if kind == "property" and have.get(name) == "attr":
            continue
        if kind == "param":
            fn, p = name[:-1].split("(")
            if p in ("key", "keys") and any(f"{fn}({d})" in have for d in DRAWS):
                continue
            if have.get(fn) != "def" or (rel, fn) in EXCLUDED:
                continue   # missing (reported), imported, or excluded
        owner = name.split(".")[0].split("(")[0]
        if "." in name and ((rel, owner) in RECORDS or (rel, owner) in EXCLUDED):
            continue       # a record's fields (test_chunk_steps_records_...), or excluded
        out.append(name)
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES if m not in PALLAS])
def test_module_has_every_public_name(rel):
    assert (PORT_PKG / rel).is_file(), f"se2lam_tpu_torch/{rel} is missing"
    missing = [n for n in _missing(rel) if (rel, n) not in EXCLUDED]
    assert not missing, f"se2lam_tpu_torch/{rel} lacks {missing}"


def test_exclusions_are_still_needed_and_reasoned():
    """Each entry names a JAX name the port really lacks, with a reason;
    the three classes of the system's surface are kept whole."""
    for (rel, name), why in EXCLUDED.items():
        assert len(why) > 20, (rel, name)
        assert name in _missing(rel), f"{rel}: {name} is ported; drop its exclusion"
        assert name.split(".")[0].split("(")[0] not in CLASSES_KEPT_WHOLE, name


def test_pallas_modules_map_to_cuda_kernels():
    for rel, (cu, wrapper_mod, names) in PALLAS.items():
        assert (PORT_PKG / cu).is_file(), cu
        have = surface(PORT_PKG / wrapper_mod)
        jax_names = {n for n, k in surface(JAX_PKG / rel).items()
                     if k in ("def", "class") and _wanted(k, n)}
        assert jax_names == set(names), (rel, jax_names)
        for port_name in names.values():
            assert have.get(port_name) == "def", (wrapper_mod, port_name)


def test_chunk_steps_records_carry_the_fields():
    for (rel, cls), record in RECORDS.items():
        fields = {n.split(".")[1] for n, k in surface(JAX_PKG / rel).items()
                  if k == "field" and n.startswith(cls + ".")}
        have = {n.split(".")[1] for n, k in surface(PORT_PKG / rel).items()
                if k == "field" and n.startswith(record + ".")}
        assert fields and fields <= have, (cls, sorted(fields - have))


def test_the_odoslam_surface_is_there():
    """F6: the names of ``se2lam_tpu/system.py:286-300, 1330-1357``."""
    have = surface(PORT_PKG / "system.py")
    for name in ("receive_odo", "receive_img", "_maybe_step", "receive_odo_data",
                 "receive_img_data", "get_current_vehicle_pose", "request_finish",
                 "wait_for_finish"):
        assert have.get(f"SlamSystem.{name}") == "def", name
