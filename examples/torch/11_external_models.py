"""Using external models inside a SimModel (PyTorch port of
examples/11_external_models.py, reference example 11, which embedded
arbitrary Keras models): here a ``torch.nn.Sequential`` MLP is the
potential, the counterpart of the JAX example's flax.linen module. Its
weights become the SimModel's trainable Variables, and the MLP is applied
functionally with them (``torch.func.functional_call``), so training and
the run's rollbacks see them as any other weight. Runs on the CUDA card
unless ``--device cpu`` is given.

Run: python examples/torch/11_external_models.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


def make_mlp(hidden=32, width=16, seed=0):
    """The MLP of the JAX example's flax module: Dense(hidden), tanh,
    Dense(hidden), tanh, Dense(1), initialised from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return torch.nn.Sequential(
            torch.nn.Linear(width, hidden), torch.nn.Tanh(),
            torch.nn.Linear(hidden, hidden), torch.nn.Tanh(),
            torch.nn.Linear(hidden, 1))


class TorchMLPPotential(htt.SimModel):
    """Wraps a torch module: built once in setup, its parameters stored as
    htt Variables (``mlp-<name>``, in ``named_parameters`` order), applied
    functionally in compute."""

    def setup(self, hidden=32):
        # a plain attribute, not a registered child: the Variables below
        # are the weights
        self.__dict__["mlp"] = make_mlp(hidden)
        self._names = []
        for name, p in self.mlp.named_parameters():
            attr = "mlp_" + name.replace(".", "_")
            setattr(self, attr, htt.Variable(p.detach(), name=f"mlp-{name}"))
            self._names.append((name, attr))

    def mlp_params(self):
        return {name: getattr(self, attr).value
                for name, attr in self._names}

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        top = torch.sort(rinv, dim=1, descending=True)[0][:, :16]
        out = torch.func.functional_call(self.mlp, self.mlp_params(),
                                         (top,))
        energy = torch.sum(out)
        return htt.compute_nlist_forces(nlist, energy)


def main(device=None):
    n = 64
    model = TorchMLPPotential(32, output_forces=False)
    model.compile(optimizer="adam", loss="mse", learning_rate=1e-3)

    sim = htt.Simulation(dt=0.002, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                         seed=0, device=device)
    sim.init_lattice(n, density=0.3, kT_init=1.0)
    lj = sim.add_force(htt.md.LennardJones(r_cut=3.0))
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=3.0, train=True, period=2)
    tfc.set_reference_forces(lj)
    before = [v.detach().clone() for v in model.mlp_params().values()]
    for epoch in range(5):
        sim.run(100)
        loss = float(np.mean(tfc.loss_history[-50:]))
        print(f"epoch {epoch}: loss = {loss:.5f}")
    # losses track the equilibrating fluid's growing label forces, so
    # they need not decrease monotonically -- but training must stay
    # finite and the parameters must actually move
    assert np.all(np.isfinite(tfc.loss_history))
    moved = any(not torch.equal(a, b.detach()) for a, b in
                zip(before, model.mlp_params().values()))
    assert moved
    return tfc.loss_history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
