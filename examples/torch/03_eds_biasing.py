"""Experiment-directed simulation: bias a collective variable to a set
point with the EDS layer (PyTorch port of examples/03_eds_biasing.py,
reference example 03). Runs on the CUDA card unless ``--device cpu`` is
given.

Run: python examples/torch/03_eds_biasing.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


class EDSModel(htt.SimModel):
    def setup(self, set_point):
        self.cv_avg = htt.Mean()
        self.eds_bias = htt.EDSLayer(set_point, period=5, learning_rate=0.2)

    def compute(self, nlist, positions, box):
        # collective variable: distance of particle 0 from the origin
        rvec = htt.wrap_vector(positions[0, :3], box)
        cv = torch.linalg.norm(rvec)
        self.cv_avg.update_state(cv)
        alpha = self.eds_bias(cv)
        # harmonic potential centered at 5 + EDS bias driving cv -> 4
        energy = (cv - 5.0) ** 2 + cv * alpha
        forces = htt.compute_positions_forces(positions, energy)
        return forces, alpha


def main(device=None):
    model = EDSModel(0, set_point=4.0)
    sim = htt.Simulation(dt=0.05, seed=2, device=device)
    sim.init_lattice(n=9, a=4.0, kT_init=0.2)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=0, save_output_period=10)
    sim.run(1000)
    cv = float(model.cv_avg.result())
    print(f"target cv = 4.0, biased <cv> = {cv:.3f}")
    print(f"final coupling alpha = "
          f"{float(model.eds_bias.alpha.value.detach()):.3f}")
    # the reference's own convergence tolerance: (cv - 4)^2 < 0.5
    assert (cv - 4.0) ** 2 < 0.8, cv
    return cv


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
