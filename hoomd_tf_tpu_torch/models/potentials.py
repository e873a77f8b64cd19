"""Ready-made potential models (PyTorch port of
``hoomd_tf_tpu/models/potentials.py``): a classical pair potential, a
trainable one and a SchNet-style neural pair potential, each a generic
:class:`.simmodel.SimModel` whose ``compute`` takes a packed neighbor list
or planes. Each is a sum of independent per-lane terms, so on
``nlist='cellwise'`` the engine's lane-separability probe
(:mod:`..ops.lane_fast`) validates it and its pair function runs in
kernel K1's generic form. Each also trains online
(``attach(train=True)``): ``TrainableLJ``'s ``nonneg`` constraints are
applied after every optimizer step.
"""

import torch

from .simmodel import SimModel
from .layers import Dense, RBFExpansion
from ..ops.forces import compute_nlist_forces
from ..ops.numerics import nlist_rinv

__all__ = ["LJPotential", "TrainableLJ", "NeuralPairPotential"]


def _lj_forces(model, nlist, epsilon, sigma):
    rinv = nlist_rinv(nlist)
    sr6 = (sigma * rinv) ** 6
    p_energy = epsilon * 4.0 / 2.0 * (sr6 * sr6 - sr6)
    energy = torch.sum(p_energy, dim=1)
    return compute_nlist_forces(nlist, energy, virial=model.virial)


class LJPotential(SimModel):
    """Fixed-parameter Lennard-Jones pair potential:
    ``setup(epsilon=1.0, sigma=1.0)``; forces and per-particle energies by
    autodiff, the virial with ``virial=True``."""

    def setup(self, epsilon=1.0, sigma=1.0):
        self.epsilon = float(epsilon)
        self.sigma = float(sigma)

    def compute(self, nlist, positions, box):
        return _lj_forces(self, nlist, self.epsilon, self.sigma)


class TrainableLJ(SimModel):
    """Lennard-Jones with trainable, non-negative ``epsilon`` and
    ``sigma`` (the weights named so, in that order, after the two
    bookkeeping variables): ``setup(epsilon=1.0, sigma=1.0)``."""

    def setup(self, epsilon=1.0, sigma=1.0):
        nonneg = lambda x: torch.clamp_min(x, 0.0)  # noqa: E731
        self.eps = self.add_weight((), initializer=float(epsilon),
                                   constraint=nonneg, name="epsilon")
        self.sig = self.add_weight((), initializer=float(sigma),
                                   constraint=nonneg, name="sigma")

    def compute(self, nlist, positions, box):
        return _lj_forces(self, nlist, self.eps, self.sig)


class NeuralPairPotential(SimModel):
    """SchNet-style neural pair potential: an RBF expansion of each
    neighbor distance, an MLP, one energy per pair (the reference's
    example-08 family): ``setup(low=0.5, high=3.0, count=32, hidden=64,
    layers=2)``. Its weights are, after the two bookkeeping variables,
    each hidden layer's kernel and bias, then the output kernel (no
    bias), as in the JAX package."""

    def setup(self, low=0.5, high=3.0, count=32, hidden=64, layers=2):
        self.rbf = RBFExpansion(low, high, count)
        self.hidden_layers = []
        for i in range(layers):
            layer = Dense(hidden, name=f"hidden{i}")
            # registered one by one, so the weights list in layer order
            self.add_module(f"hidden{i}", layer)
            self.hidden_layers.append(layer)
        self.out = Dense(1, use_bias=False, name="out")

    def compute(self, nlist, positions, box):
        rinv = nlist_rinv(nlist)
        # padded slots have rinv == 0: mask their pair energies
        mask = (rinv > 0).to(self.dtype)
        r = torch.where(rinv > 0, 1.0 / torch.clamp_min(rinv, 1e-6),
                        torch.zeros_like(rinv))
        x = self.rbf(r)                                   # [N, NN, count]
        for layer in self.hidden_layers:
            x = torch.tanh(layer(x))
        p_energy = self.out(x)[..., 0] * mask             # [N, NN]
        energy = torch.sum(p_energy, dim=1) / 2.0         # double count
        return compute_nlist_forces(nlist, energy, virial=self.virial)
