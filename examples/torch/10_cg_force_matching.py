"""End-to-end coarse-grained force matching from a REAL trajectory file
(PyTorch port of examples/10_cg_force_matching.py, reference examples
06/10, BASELINE config[3]):

1. load the committed GSD trajectory ``examples/data/dimer_fluid.gsd``
   (read only) -- a real HOOMD-schema file carrying positions,
   velocities, per-particle forces AND bond topology. With MDAnalysis
   installed the same file is read through ``MDAnalysis.Universe``;
   otherwise the package's native ``GSDUniverse`` reads it with no
   optional dependency. A missing file raises.
2. stream frames with ``iter_from_trajectory`` (the reference's
   trajectory-driven pipeline, ``utils.py:627-749``), map atoms -> CG
   beads (PBC center of mass) and project forces onto beads with the
   mapping operator,
3. train a CG pair potential on the mapped data.

Runs on the CUDA card unless ``--device cpu`` is given.

Run: python examples/torch/10_cg_force_matching.py [--device cpu]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402

DATA = os.path.join(HERE, "..", "data", "dimer_fluid.gsd")
R_CUT = 3.0


def load_universe(path):
    """Open the trajectory: MDAnalysis when installed, the native GSD
    reader otherwise. Returns ``(universe, bonds [B,2])``."""
    try:
        import MDAnalysis as mda

        u = mda.Universe(path)
        bonds = np.asarray(u.bonds.to_indices(), dtype=np.int64)
        print(f"loaded {path} via MDAnalysis {mda.__version__}")
    except Exception:  # no MDAnalysis (or no mda GSD reader) -> native
        u = htt.GSDUniverse(path)
        bonds = u.bonds
        print(f"loaded {path} via native GSDUniverse")
    return u, bonds


def read_frames(universe, path, nn, device):
    """Stream ``(positions, forces)`` tensors per frame through
    ``iter_from_trajectory``. Force labels come from ``frame.forces`` when
    the universe carries them; otherwise (e.g. an MDAnalysis GSD reader
    without force support) they are re-read with the native ``GSDFile``."""
    native = htt.GSDFile(path)
    data = []
    for i, (inputs, frame) in enumerate(
            htt.iter_from_trajectory(nn, universe, r_cut=R_CUT,
                                     device=device)):
        try:
            forces = np.asarray(frame.forces)
        except (AttributeError, ValueError):
            forces = np.asarray(
                native.read_chunk(i, "log/particles/force"))
        positions = inputs[1][:, :3]
        data.append((positions, torch.as_tensor(
            forces, device=positions.device)))
    native.close()
    return data


def main(device=None, epochs=8):
    device = device or "cuda"
    if not os.path.exists(DATA):
        raise FileNotFoundError(
            f"{DATA} is missing: it is committed with the repository "
            "(examples/data/generate_fixture.py regenerates it)")

    universe, bonds = load_universe(DATA)
    n_atoms = len(universe.select_atoms("all"))
    box_l = np.asarray(universe.dimensions[:3], dtype=np.float64)
    data = read_frames(universe, DATA, 32, device)
    print(f"{len(data)} frames x {n_atoms} atoms, {len(bonds)} bonds, "
          f"box {box_l.tolist()}")

    # molecules from the file's bond topology (one dimer per bond here)
    class _Topology:
        pass

    top = _Topology()
    top.bonds = bonds
    top.particles = range(n_atoms)
    mol_indices = htt.find_molecules(top)
    n_mol = len(mol_indices)

    # CG mapping: one bead per dimer, equal weights
    mol_map = np.full((1, 2), 0.5)
    mapping = htt.sparse_mapping([mol_map] * n_mol, mol_indices,
                                 device=device)

    # CG model: trainable LJ between beads
    NN = 16
    model = htt.TrainableLJ(NN, epsilon=0.5, sigma=0.8).to(device)
    model.compile(optimizer="adam", loss="mse", learning_rate=2e-2)
    box = htt.box_from_lengths(box_l, device=device)

    for epoch in range(epochs):
        losses = []
        for positions, forces in data:
            cg_pos = htt.center_of_mass(positions, mapping, box_l)
            # force projection onto beads: the mapping operator applied to
            # atomistic forces (the standard CG force-matching target)
            cg_forces = 2.0 * (mapping @ forces)  # d(COM)/dx
            cg_pos4 = torch.cat(
                [cg_pos, torch.zeros((n_mol, 1), dtype=cg_pos.dtype,
                                     device=cg_pos.device)], dim=1)
            nlist = htt.compute_nlist(cg_pos4, R_CUT, NN, box_l,
                                      sorted=True, return_types=True)
            losses.append(model.train_on_batch([nlist, cg_pos4, box],
                                               cg_forces))
        losses = torch.stack(losses).cpu().numpy()
        print(f"epoch {epoch}  loss={np.mean(losses):.4f}  "
              f"eps={float(model.eps.detach()):.3f}  "
              f"sig={float(model.sig.detach()):.3f}")

    print("trained CG pair potential from the real mapped trajectory")
    assert np.all(np.isfinite(losses))
    assert float(model.eps.detach()) > 0
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
