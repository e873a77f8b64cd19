"""Quickstart: a Lennard-Jones pair potential as a SimModel driving an NVT
simulation (PyTorch port of examples/01_quickstart.py, reference example
01). Runs on the CUDA card unless ``--device cpu`` is given.

Run: python examples/torch/01_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import hoomd_tf_tpu_torch as htt  # noqa: E402


class LJModel(htt.SimModel):
    def compute(self, nlist, positions, box):
        # 1/r with NaN-safe handling of padded neighbor slots
        rinv = htt.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        # pairwise energy; the full neighbor list double counts -> / 2
        p_energy = 4.0 / 2.0 * (inv_r6 * inv_r6 - inv_r6)
        energy = torch.sum(p_energy, dim=1)
        return htt.compute_nlist_forces(nlist, energy)


def main(device=None):
    model = LJModel(64)
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.2, tau=0.5),
                         seed=42, device=device)
    sim.init_lattice(n=256, density=0.4, kT_init=1.2)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=3.0)

    for _ in range(5):
        sim.run(200)
        t = sim.thermo()
        print(f"step {int(sim.state.step):5d}  "
              f"PE={t['potential_energy']:+.3f}  "
              f"T={t['temperature']:.3f}  P={t['pressure']:+.4f}")

    # the thermostat holds the fluid near the target temperature
    assert abs(t["temperature"] - 1.2) < 0.6, t
    assert t["potential_energy"] < 0.0, t
    return t


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
