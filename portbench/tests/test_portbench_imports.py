"""The benchmark imports neither JAX nor the JAX package (compared by the
module's whole top-level name, so ``pigs_tpu_torch`` passes and
``pigs_tpu`` fails), and the plain reference nothing of the program."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pigs_tpu"}


def imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(HERE)} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in imported(path)
           if m.split(".")[0] in FORBIDDEN | {"pigs_tpu_torch"}]
    assert not bad, f"{path.name} imports {bad}"


def test_whole_name_comparison():
    names = ["pigs_tpu_torch.train.pn", "pigs_tpu.models", "jaxtyping"]
    assert [n for n in names if n.split(".")[0] in FORBIDDEN] == \
        ["pigs_tpu.models"]


def test_scan_sees_the_harness():
    names = {p.name for p in FILES}
    assert {"run.py", "pn.py", "train.py", "rollout.py", "traffic.py",
            "workcount.py", "trace.py"} <= names
