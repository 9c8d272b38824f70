"""The PyTorch port imports no JAX-family module and nothing of pigs_tpu.

A static scan of the ASTs: importing the package to look would prove
nothing here, since the test process has JAX loaded already.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "pigs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "rollout_torch.py",
    ROOT / "scripts" / "train_pn_torch.py",
    ROOT / "scripts" / "validate_pn_torch.py",
    ROOT / "scripts" / "plot_rollout_torch.py",
    ROOT / "scripts" / "validate_ns_torch.py",
    ROOT / "scripts" / "solve_no_mlp_torch.py",
    ROOT / "scripts" / "validate_no_mlp_2d_torch.py",
    ROOT / "scripts" / "aggregate_balance_torch.py",
    ROOT / "scripts" / "initialize_torch.py",
    ROOT / "scripts" / "select_split_stop_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pigs_tpu")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"mixture_kernel.py", "aggregate_kernel.py", "model.py", "pn.py",
            "convert.py", "optim.py", "checkpoint.py", "train_pn_torch.py",
            "validate_pn_torch.py", "plot_rollout_torch.py", "plotting.py",
            "validate_ns_torch.py", "fd.py", "no_mlp.py", "card.py",
            "solve_no_mlp_torch.py", "validate_no_mlp_2d_torch.py",
            "fit.py", "ns_data.py", "initialize_torch.py", "profiling.py",
            "launch.py", "mesh.py", "sharded.py",
            "select_split_stop_torch.py"} <= names
    assert ROOT / "pigs_tpu_torch" / "parallel" / "train.py" in PORT_FILES
    assert ROOT / "pigs_tpu_torch" / "native" / "__init__.py" in PORT_FILES


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("import numpy\nfrom jax import numpy as jnp\n"
                 "from pigs_tpu.ops import oracle\n")
    assert [m for m in imported_modules(f)
            if m.split(".")[0] in FORBIDDEN] == ["jax", "pigs_tpu.ops"]
