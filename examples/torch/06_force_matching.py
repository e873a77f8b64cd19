"""Offline force matching from a trajectory file: learn pair parameters
from frames + per-frame label forces surfaced by iter_from_trajectory
(PyTorch port of examples/06_force_matching.py, reference examples 05/06
and utils.py:666-686, where the selection sub-universe carries
ts.forces).

The trajectory is generated in-process by running the built-in LJ fluid
and written to a GSD file with per-frame forces through the native
writer; iter_from_trajectory then reads it back with no optional
dependency. Runs on the CUDA card unless ``--device cpu`` is given.

Run: python examples/torch/06_force_matching.py [--device cpu]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


class TrainableLJ(htt.SimModel):
    def setup(self):
        # the LJ force-MSE landscape has a narrow curved valley
        # (eps*sigma^12 ~ const); start inside the physical basin
        self.eps = htt.Variable(0.8, name="epsilon")
        self.sig = htt.Variable(1.1, name="sigma")

    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        sr6 = (self.sig.value * rinv) ** 6
        p_energy = self.eps.value * 4.0 / 2.0 * (sr6 ** 2 - sr6)
        energy = torch.sum(p_energy, dim=1)
        return htt.compute_nlist_forces(nlist, energy)


class _Observer(htt.SimModel):
    def compute(self, nlist):
        return torch.zeros(())


def generate_gsd(path, n=64, frames=20, r_cut=3.0, device=None):
    """Run the true LJ fluid and dump a GSD trajectory with forces."""
    sim = htt.Simulation(dt=0.002, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                         seed=3, device=device)
    sim.init_lattice(n, density=0.3, kT_init=1.0)
    sim.add_force(htt.md.LennardJones(r_cut=r_cut))
    obs = htt.tfcompute(_Observer(n - 1, output_forces=False))
    obs.attach(sim, r_cut=r_cut)
    recorded = []
    for _ in range(frames):
        sim.run(20)
        st = sim.state
        recorded.append({"positions": st.positions.clone(),
                         "velocity": st.velocities.clone(),
                         "forces": st.forces[:, :3].clone(),
                         "typeid": np.zeros(n, np.uint32)})
    htt.write_gsd_frames(path, recorded, box=htt.box_size(sim.state.box))
    return path


def fit(path, nn=48, r_cut=3.0, epochs=18, device=None, log=print,
        model=None):
    """Adam (2e-2) on the force MSE over every frame of ``path``, once per
    epoch, from a new :class:`TrainableLJ` or, to train on, ``model``;
    returns the model."""
    if model is None:
        model = TrainableLJ(nn).to(device or "cuda")
        model.compile(optimizer="adam", loss="mse", learning_rate=2e-2)
    universe = htt.GSDUniverse(path)
    for epoch in range(epochs):
        losses = []
        # ts.forces: per-frame label forces straight from the trajectory
        for inputs, ts in htt.iter_from_trajectory(nn, universe,
                                                   r_cut=r_cut,
                                                   device=device):
            labels = torch.as_tensor(ts.forces, device=inputs[1].device)
            losses.append(model.train_on_batch(inputs, labels))
        log(f"epoch {epoch}  loss={float(torch.stack(losses).mean()):.5f}"
            f"  eps={float(model.eps.value.detach()):.3f}  "
            f"sig={float(model.sig.value.detach()):.3f}")
    return model


def main(device=None):
    # NN must cover every in-range neighbor or the dropped tails bias
    # the fit (max occupancy here is ~34 at r_cut=3)
    nn, r_cut = 48, 3.0
    tmp = tempfile.mkdtemp()
    try:
        path = generate_gsd(os.path.join(tmp, "lj_fluid.gsd"), r_cut=r_cut,
                            device=device)
        print(f"wrote trajectory with per-frame forces: {path}")
        model = fit(path, nn, r_cut, device=device)
    finally:
        shutil.rmtree(tmp)
    eps = float(model.eps.value.detach())
    sig = float(model.sig.value.detach())
    print("true parameters: eps=1.0 sig=1.0")
    assert abs(eps - 1.0) < 0.2
    assert abs(sig - 1.0) < 0.1
    return eps, sig


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
