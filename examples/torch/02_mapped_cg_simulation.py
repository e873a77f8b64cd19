"""Preparing a coarse-grained mapped simulation: CG beads live alongside
the all-atom particles so the engine builds bead-bead neighbor lists
natively (PyTorch port of examples/02_mapped_cg_simulation.py, reference
example 02). Runs on the CUDA card unless ``--device cpu`` is given.

Run: python examples/torch/02_mapped_cg_simulation.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


class MappedModel(htt.SimModel):
    @staticmethod
    def com_mapping(pos4, box_lengths):
        """Map 27 atoms into 3 CG beads of 9 atoms (columns: xyz + bead
        type)."""
        groups = pos4[:, :3].reshape(3, 9, 3)
        cg = torch.mean(groups, dim=1)
        types = torch.zeros((3, 1), dtype=cg.dtype, device=cg.device)
        return torch.cat([cg, types], dim=1)

    def setup(self):
        self.avg_cg_rdf = htt.MeanTensor()

    def compute(self, nlist, positions, box):
        aa_nlist, cg_nlist = self.mapped_nlist(nlist)
        aa_pos, cg_pos = self.mapped_positions(positions)
        # observable on the CG beads only
        rdf, rs = htt.compute_rdf(cg_nlist, [0.5, 6.0], nbins=20)
        self.avg_cg_rdf.update_state(rdf)
        # forces act on the all-atom particles (simple 1/r repulsion)
        rinv = htt.nlist_rinv(aa_nlist)
        energy = torch.sum(rinv, dim=1)
        return htt.compute_nlist_forces(aa_nlist, energy)


def main(device=None):
    n = 27
    model = MappedModel(16)
    sim = htt.Simulation(dt=0.002, integrator=htt.md.NVT(kT=0.8, tau=0.5),
                         seed=3, device=device)
    sim.init_lattice(n, a=2.0, kT_init=0.8)
    tfc = htt.tfcompute(model)
    aa_group, cg_group = tfc.enable_mapped_nlist(sim,
                                                 MappedModel.com_mapping)
    print(f"{len(aa_group)} atoms + {len(cg_group)} mapped beads")
    tfc.attach(sim, r_cut=6.0)
    sim.run(200)
    print("CG bead positions (recomputed from the mapping every step):")
    print(np.round(tfc.get_positions_array()[n:], 3))
    rdf_sum = float(model.avg_cg_rdf.result().sum())
    print("CG-CG rdf mean:", rdf_sum)
    assert np.all(np.isfinite(tfc.get_positions_array()))
    assert rdf_sum > 0.0
    return rdf_sum


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
