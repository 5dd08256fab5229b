"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port either. Module names are compared
by their whole top-level name (the part before the first dot): the port's
name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "differential_equations_dnn_tpu"}
PORT = "differential_equations_dnn_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported(path):
    """Top-level names of every module the file imports, including by
    ``importlib.import_module`` of a string constant or f-string head."""
    tree = ast.parse(path.read_text())
    consts = {t.id: n.value.value for n in ast.walk(tree)
              if isinstance(n, ast.Assign) and isinstance(n.value,
                                                          ast.Constant)
              for t in n.targets if isinstance(t, ast.Name)}
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args):
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                arg = arg.values[0]
                if isinstance(arg, ast.FormattedValue):
                    arg = arg.value
            if isinstance(arg, ast.Name):
                names.add(consts.get(arg.id, arg.id))
            elif isinstance(arg, ast.Constant):
                names.add(str(arg.value))
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported(path)


def test_the_scan_sees_the_drivers_import():
    assert PORT in imported(HERE / "traffic" / "solve_loop.py")
    assert PORT in imported(HERE / "traffic" / "train_loop.py")
