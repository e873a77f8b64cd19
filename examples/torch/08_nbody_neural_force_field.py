"""Online N-body neural force field: train a NN potential against a
reference force field *while the simulation runs*, with early stopping
(PyTorch port of examples/08_nbody_neural_force_field.py, reference
example 08). Runs on the CUDA card unless ``--device cpu`` is given.

Run: python examples/torch/08_nbody_neural_force_field.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


class NNPotential(htt.SimModel):
    def setup(self, dim=16, top_neighs=16):
        self.rbf = htt.RBFExpansion(0.5, 3.0, dim)
        self.dense1 = htt.Dense(dim)
        self.last = htt.Dense(1, use_bias=False)
        self.top_neighs = top_neighs

    def compute(self, nlist, positions, box, training=False):
        rinv = htt.nlist_rinv(nlist)
        top = torch.sort(rinv, dim=1, descending=True)[0]
        top = top[:, :self.top_neighs]
        x = self.rbf(htt.divide_no_nan(1.0, top))
        x = torch.tanh(self.dense1(x))
        energy = torch.sum(self.last(x), dim=(1, 2))
        forces = htt.compute_nlist_forces(nlist, energy)
        return forces


def main(device=None, epochs=30):
    n, nn, r_cut = 64, 32, 3.0
    model = NNPotential(nn, output_forces=False)
    model.compile(optimizer="adam", loss="mse", learning_rate=1e-3)

    sim = htt.Simulation(dt=0.002, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                         seed=0, device=device)
    sim.init_lattice(n, density=0.3, kT_init=1.0)
    lj = sim.add_force(htt.md.LennardJones(epsilon=1.0, sigma=1.0,
                                           r_cut=r_cut))
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=r_cut, train=True, period=2)
    tfc.set_reference_forces(lj)

    # online training with early stopping (host-side control between
    # runs, like the reference's example 08)
    best, patience, bad = np.inf, 5, 0
    first_loss = None
    for epoch in range(epochs):
        sim.run(100)
        loss = float(np.mean(tfc.loss_history[-50:]))
        if first_loss is None:
            first_loss = loss
        print(f"epoch {epoch:2d}  loss={loss:.5f}")
        if loss < best * 0.995:
            best, bad = loss, 0
        else:
            bad += 1
            if bad >= patience:
                print("early stopping")
                break
    print(f"final loss {best:.5f}")
    assert np.isfinite(best)
    assert best <= first_loss, (best, first_loss)
    return best


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
