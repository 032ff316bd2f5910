"""No run loads JAX or the JAX package; the reference imports nothing of
the program. Module names are compared whole, by their first part:
the port's package name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from harness import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(BENCH, "reference")
FORBIDDEN_IN_REFERENCE = {"jax", "jaxlib", "flax", "strongsort_yolo_tpu",
                          "strongsort_yolo_tpu_torch"}


def test_port_allowed_jax_package_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "strongsort_yolo_tpu_torch.fake", object())
    for name in list(sys.modules):
        if name.split(".")[0] in cell.JAX_NAMES:
            monkeypatch.delitem(sys.modules, name)
    assert cell.jax_modules() == []
    monkeypatch.setitem(sys.modules, "strongsort_yolo_tpu.pipeline", object())
    assert cell.jax_modules() == ["strongsort_yolo_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert cell.jax_modules() == ["jaxlib", "strongsort_yolo_tpu"]


def imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_sources_import_nothing_of_the_program():
    for f in sorted(os.listdir(REFERENCE)):
        if f.endswith(".py"):
            bad = set(imported_roots(os.path.join(REFERENCE, f))) & FORBIDDEN_IN_REFERENCE
            assert not bad, f"{f} imports {bad}"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import importlib, os\n"
            "for f in sorted(os.listdir(os.path.join(sys.argv[1], 'reference'))):\n"
            "    if f.endswith('.py') and f != '__init__.py':\n"
            "        importlib.import_module('reference.' + f[:-3])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set("
            f"{sorted(FORBIDDEN_IN_REFERENCE)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code, BENCH], capture_output=True,
                         text=True, check=True, cwd="/")
    assert out.stdout.strip() == "[]"
