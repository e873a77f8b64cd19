"""The port imports torch and numpy only: never JAX, optax or the JAX
package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hoomd_tf_tpu_torch"


# every module of the port, the online-training slice's included
MODULES = ("hoomd_tf_tpu_torch", "hoomd_tf_tpu_torch.interop",
           "hoomd_tf_tpu_torch.ops.chebyshev",
           "hoomd_tf_tpu_torch.ops.pair_train",
           "hoomd_tf_tpu_torch.ops.pair_train_cuda",
           "hoomd_tf_tpu_torch.models.layers",
           "hoomd_tf_tpu_torch.md.simulation")


def test_import_without_jax():
    code = ("import sys, importlib; "
            f"[importlib.import_module(m) for m in {MODULES!r}]; "
            "bad = [m for m in ('jax', 'optax', 'hoomd_tf_tpu') "
            "if m in sys.modules]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_statement():
    """No module of the port names JAX or the JAX package in an import
    (checked on the source, so lazy imports inside functions count too)."""
    banned = ("jax", "optax", "hoomd_tf_tpu")
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


@pytest.mark.parametrize("where", ["alone", "checkout"])
def test_chip_smoke_refuses_without_card_or_checkout(where, tmp_path):
    """chip_smoke.py fails and prints no result line when it is away
    from the repository, or when there is no CUDA card."""
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    else:
        import torch
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: chip_smoke.py would run")
        script, cwd = ROOT / "chip_smoke.py", ROOT
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
