"""Trainable WCA repulsion + running RDF observable during simulation
(PyTorch port of examples/04_particle_simulations.py, reference examples
02/04: custom layers + metrics in the simulation loop). Runs on the CUDA
card unless ``--device cpu`` is given.

Run: python examples/torch/04_particle_simulations.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


class WCARDF(htt.SimModel):
    def setup(self):
        self.wca = htt.WCARepulsion(0.9)
        self.avg_rdf = htt.MeanTensor()

    def compute(self, nlist, positions, box):
        p_energy = self.wca(nlist)
        forces = htt.compute_nlist_forces(nlist, p_energy)
        rdf, rs = htt.compute_rdf(nlist, [0.5, 3.0], positions[:, 3])
        self.avg_rdf.update_state(rdf)
        return forces


def main(device=None):
    model = WCARDF(48)
    sim = htt.Simulation(dt=0.002, integrator=htt.md.Langevin(kT=0.8,
                                                              gamma=1.0),
                         seed=7, device=device)
    sim.init_lattice(n=216, density=0.5, kT_init=0.8)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=3.0)
    sim.run(1000)
    rdf = model.avg_rdf.result()
    print("running-mean RDF (unnormalized):")
    print(torch.round(rdf.cpu(), decimals=3))
    t = sim.thermo()
    print("thermo:", t)
    assert float(torch.sum(rdf)) > 0.0
    assert abs(t["temperature"] - 0.8) < 0.5, t
    return t


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
