"""The port imports torch and numpy only: never JAX, optax or the JAX
package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hoomd_tf_tpu_torch"


# every module of the port, the online-training, packed, generic-model and
# coarse-grained slices' included
MODULES = ("hoomd_tf_tpu_torch", "hoomd_tf_tpu_torch.interop",
           "hoomd_tf_tpu_torch.utils", "hoomd_tf_tpu_torch.utils.cg",
           "hoomd_tf_tpu_torch.utils.graph",
           "hoomd_tf_tpu_torch.utils.mol_features",
           "hoomd_tf_tpu_torch.utils.pdb_io",
           "hoomd_tf_tpu_torch.utils.trajectory",
           "hoomd_tf_tpu_torch.utils.gsd_io",
           "hoomd_tf_tpu_torch.utils.profiling",
           "hoomd_tf_tpu_torch.ops.direct",
           "hoomd_tf_tpu_torch.ops.rdf",
           "hoomd_tf_tpu_torch.ops.lane_fast",
           "hoomd_tf_tpu_torch.ops.cellwise_cuda",
           "hoomd_tf_tpu_torch.models.potentials",
           "hoomd_tf_tpu_torch.ops.chebyshev",
           "hoomd_tf_tpu_torch.ops.pair_train",
           "hoomd_tf_tpu_torch.ops.pair_train_cuda",
           "hoomd_tf_tpu_torch.ops.numerics",
           "hoomd_tf_tpu_torch.ops.forces",
           "hoomd_tf_tpu_torch.ops.nlist",
           "hoomd_tf_tpu_torch.ops.cell_list",
           "hoomd_tf_tpu_torch.ops.cell_stencil",
           "hoomd_tf_tpu_torch.ops.nlist_cuda",
           "hoomd_tf_tpu_torch.models.layers",
           "hoomd_tf_tpu_torch.md.pair",
           "hoomd_tf_tpu_torch.md.simulation",
           "hoomd_tf_tpu_torch.driver",
           "hoomd_tf_tpu_torch.serialize",
           "hoomd_tf_tpu_torch.parallel",
           "hoomd_tf_tpu_torch.parallel.mesh",
           "hoomd_tf_tpu_torch.parallel.domain",
           "hoomd_tf_tpu_torch.parallel.shard",
           "hoomd_tf_tpu_torch.parallel.sharded_simulation")


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


def test_gsd_io_loads_without_jax(tmp_path):
    """Loading the port's GSD module, building its native library and
    writing and reading a file put neither JAX nor the JAX package (whose
    own GSD library sits under a package that imports JAX) into
    ``sys.modules``."""
    path = tmp_path / "t.gsd"
    code = ("import sys, numpy as np; "
            "from hoomd_tf_tpu_torch.utils import gsd_io; "
            f"gsd_io.write_gsd_frames({str(path)!r}, "
            "[{'positions': np.ones((3, 3))}], box=[2.0, 2.0, 2.0]); "
            f"f = gsd_io.GSDFile({str(path)!r}); "
            "assert f.read_chunk(0, 'particles/position').shape == (3, 3); "
            "f.close(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'hoomd_tf_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_scripts_import_no_jax():
    """Neither the port's example scripts nor chip_smoke.py name JAX or the
    JAX package in an import."""
    banned = ("jax", "flax", "optax", "hoomd_tf_tpu")
    paths = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert len(paths) == 11
    for path in paths + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_no_jax_import_statement():
    """No module of the port names JAX or the JAX package in an import
    (checked on the source, so lazy imports inside functions count too),
    its subpackages included."""
    banned = ("jax", "optax", "hoomd_tf_tpu")
    paths = sorted(PKG.rglob("*.py"))
    assert PKG / "utils" / "cg.py" in paths
    for path in paths:
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


# The JAX package's public names the port does not export yet, each with
# the ROADMAP.md Queue 1 item that brings it: none since parallel (item 7).
PENDING = {
    "": {},
    "md": {},
    "ops": {},
    "models": {},
    "utils": {},
    "parallel": {},
}


@pytest.mark.parametrize("space", ["", "md", "ops", "models", "utils",
                                   "parallel"])
def test_namespaces_match_jax(space):
    """Each namespace's ``__all__`` is the JAX package's less the names
    still to come (``PENDING``, by Queue 1 item), and every listed name
    is there; no pending name is exported yet (the list stays true)."""
    import importlib
    jax_ns = importlib.import_module(
        "hoomd_tf_tpu" + (f".{space}" if space else ""))
    port_ns = importlib.import_module(
        "hoomd_tf_tpu_torch" + (f".{space}" if space else ""))
    pending = PENDING[space]
    assert set(pending) <= set(jax_ns.__all__)
    assert set(port_ns.__all__) == set(jax_ns.__all__) - set(pending)
    assert len(port_ns.__all__) == len(set(port_ns.__all__))
    for name in port_ns.__all__:
        assert hasattr(port_ns, name), name
    for name in pending:
        assert not hasattr(port_ns, name), (name, pending[name])
