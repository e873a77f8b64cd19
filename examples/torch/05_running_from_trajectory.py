"""Running a model from a trajectory file, no simulation engine (PyTorch
port of examples/05_running_from_trajectory.py, reference example 05).
Uses the package's native GSD library, so neither MDAnalysis nor the gsd
package is required. Runs on the CUDA card unless ``--device cpu`` is
given.

Run: python examples/torch/05_running_from_trajectory.py [--device cpu]
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


class RDFModel(htt.SimModel):
    def setup(self):
        self.avg_rdf = htt.MeanTensor()

    def compute(self, nlist, positions, box):
        rdf, rs = htt.compute_rdf(nlist, [0.5, 3.0], positions[:, 3])
        self.avg_rdf.update_state(rdf)
        return rdf


class _NoOp(htt.SimModel):
    def compute(self, nlist):
        return torch.zeros(())


def generate_trajectory(path, frames=10, n=64, device=None):
    """Write a short LJ trajectory with the native GSD writer (the frames'
    tensors go to the host once per frame)."""
    sim = htt.Simulation(dt=0.002, integrator=htt.md.NVT(kT=1.0, tau=0.5),
                         seed=1, device=device)
    sim.init_lattice(n, density=0.4, kT_init=1.0)
    sim.add_force(htt.md.LennardJones(r_cut=3.0))
    obs = htt.tfcompute(_NoOp(0, output_forces=False))
    obs.attach(sim, r_cut=0)
    data = []
    for _ in range(frames):
        sim.run(25)
        data.append({"positions": sim.state.positions.clone(),
                     "typeid": np.zeros(n, np.uint32)})
    htt.write_gsd_frames(path, data, box=htt.box_size(sim.state.box))
    return path


def trajectory_rdf(path, nn=32, r_cut=3.0, device=None):
    """The trajectory-averaged RDF of :class:`RDFModel` over every frame
    of ``path``: ``(rdf, bin centers)`` as numpy."""
    universe = htt.GSDUniverse(path)
    model = RDFModel(nn).to(device or "cuda")
    for inputs, ts in htt.iter_from_trajectory(nn, universe, r_cut=r_cut,
                                               device=device):
        model(inputs)
    rdf = model.avg_rdf.result().detach().cpu().numpy()
    rs = np.linspace(0.5, 3.0, 101)
    return rdf, (rs[1:] + rs[:-1]) / 2


def check_rdf(rdf, rs):
    """The example's gates on a trajectory-averaged RDF."""
    peak = int(np.argmax(rdf))
    assert np.all(np.isfinite(rdf))
    assert 0.8 < rs[peak] < 2.8, rs[peak]
    # excluded-volume hole: no density below ~0.9 sigma
    assert float(np.sum(rdf[rs < 0.85])) < 1e-3 * float(np.sum(rdf))
    return peak


def main(device=None):
    tmp = tempfile.mkdtemp()
    try:
        path = generate_trajectory(os.path.join(tmp, "traj.gsd"),
                                   device=device)
        rdf, rs = trajectory_rdf(path, device=device)
    finally:
        shutil.rmtree(tmp)
    peak = int(np.argmax(rdf))
    print(f"trajectory-averaged RDF max at r = {rs[peak]:.2f} "
          f"(unnormalized histogram: shell volume shifts the max past "
          f"the LJ first shell at ~1.1-1.3)")
    print("g(r) around the max:", np.round(rdf[peak - 3:peak + 4], 2))
    check_rdf(rdf, rs)
    return rdf


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
