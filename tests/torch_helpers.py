"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages, so
the JAX package (the reference) and the PyTorch port see the same
numbers. Torch runs single-threaded: the suite runs under several xdist
workers at once.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def fluid_arrays(n, density, seed=0, jitter=0.2, kT=1.0):
    """A jittered simple-cubic lattice with Maxwell-Boltzmann velocities:
    numpy ``(positions, velocities, lengths)``. The jitter is bounded, as
    in tests/test_cellwise.py, so no pair overlaps deeply."""
    from hoomd_tf_tpu_torch.md.state import lattice_positions
    pos, lengths = lattice_positions(n, density=density)
    rng = np.random.RandomState(seed)
    pos = pos + jitter * rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * np.float32(
        np.sqrt(kT))
    vel -= vel.mean(axis=0)
    return pos.astype(np.float32), vel.astype(np.float32), lengths


def jax_state(pos, vel, lengths, types=None):
    from hoomd_tf_tpu.md.state import init_state
    return init_state(pos, lengths, types=types, velocities=vel)


def torch_state(pos, vel, lengths, types=None, device="cpu"):
    from hoomd_tf_tpu_torch.md.state import init_state
    return init_state(pos, lengths, types=types, velocities=vel,
                      device=device)


def packed_pair(n, density, seed, r_cut, typed=False, rc_matrix=None,
                jitter=0.2):
    """The same fluid packed into slots by both packages:
    ``(jax_layout, jax_slot_state, jax_aux), (port_layout, port_slot_state,
    port_aux)`` on identical plans."""
    from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
    from hoomd_tf_tpu.ops import cellwise as jcw
    from hoomd_tf_tpu_torch.md.slots import SlotLayout as TLayout
    from hoomd_tf_tpu_torch.ops import cellwise as tcw
    pos, vel, lengths = fluid_arrays(n, density, seed, jitter=jitter)
    types = (np.arange(n) % 2) if typed else None
    js = jax_state(pos, vel, lengths, types=types)
    ts = torch_state(pos, vel, lengths, types=types)
    lo = np.asarray(js.box[0])
    jplan = jcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo)
    tplan = tcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo)
    assert (tplan.grid, tplan.capacity) == (jplan.grid, jplan.capacity)
    jl, tl = JLayout(jplan, n, lo), TLayout(tplan, n, lo,
                                            rc_matrix=rc_matrix,
                                            device="cpu")
    jss, jaux, _ = jl.pack(js)
    tss, taux = tl.pack(ts)
    return (jl, jss, jaux), (tl, tss, taux)


def hole_permutation(valid, capacity):
    """A slot permutation that moves the first particle of every cell with
    room into the cell's first empty slot, so that the occupied slots of
    those cells are no longer a prefix: ``new[i] = old[perm[i]]`` (a
    packed, prefix-occupied ``valid`` in)."""
    v = valid.detach().cpu().numpy().reshape(-1, capacity) > 0
    perm = np.arange(v.size).reshape(-1, capacity)
    for c, row in enumerate(v):
        o = int(row.sum())
        if 0 < o < capacity:
            perm[c, [0, o]] = perm[c, [o, 0]]
    return torch.as_tensor(perm.ravel(), device=valid.device)


def jax_state_numpy(state):
    """A JAX SimState's arrays as numpy (the input of
    ``interop.state_from_numpy``)."""
    out = {f.name: np.asarray(getattr(state, f.name))
           for f in dataclasses.fields(state)
           if f.name not in ("rng", "thermostat")}
    out["thermostat"] = {k: np.asarray(v)
                         for k, v in (state.thermostat or {}).items()}
    return out


def np_(t):
    """A torch tensor or JAX array as numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: tests that need the card run on the
    machine with one (the decision is made here, at run time, never while
    a test module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100 machine)")
    return torch.device("cuda")


def lj_slope_jax(r2, ti=None, tj=None):
    """A two-type LJ pair function (JAX), as tests/test_cellwise.py's."""
    import jax.numpy as jnp
    u = 1.0 / r2
    sr6 = u * u * u
    eps = jnp.where((ti == 0) & (tj == 0), 1.0, 0.5)
    return (4.0 * eps * (sr6 * sr6 - sr6),
            -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * u)


def lj_slope_torch(r2, ti=None, tj=None):
    """The same pair function in torch."""
    u = 1.0 / r2
    sr6 = u * u * u
    eps = torch.where((ti == 0) & (tj == 0), 1.0, 0.5)
    return (4.0 * eps * (sr6 * sr6 - sr6),
            -12.0 * eps * (2.0 * sr6 - 1.0) * sr6 * u)


def force_loss(yt, yp):
    """Force matching on ``forces[:, :3]`` (the north-star protocol's
    loss; the energy column is not trained)."""
    return torch.mean((yt[:, :3] - yp[:, :3]) ** 2)


def nn_pair_class():
    """The north-star protocol's NN pair potential in the port: an MLP on
    ``1/r`` with widths 16 -> 1 (``benchmarks/north_star.py``)."""
    import hoomd_tf_tpu_torch as htt

    class NNPair(htt.PairModel):
        def setup(self):
            self.dense1 = htt.Dense(16)
            self.last = htt.Dense(1)

        def pair_energy(self, r2):
            x = torch.tanh(self.dense1(torch.rsqrt(r2)[..., None]))
            return 2.0 * self.last(x)[..., 0]

    return NNPair


def seed_jax_weights(jm, seed=0):
    """Set a built JAX NN model's layer weights to a draw from ``seed``
    (Glorot-uniform kernels, zero biases); SimModel's two bookkeeping
    variables stay. The JAX package's lazy layers draw from one key
    stream per process, so their own draw depends on how many layers the
    process built before: under xdist, on which test files ran first."""
    rng = np.random.RandomState(seed)
    weights = jm.get_weights()
    out = list(weights[:2])
    for w in weights[2:]:
        w = np.asarray(w)
        if w.ndim == 2:
            lim = np.sqrt(6.0 / sum(w.shape))
            out.append(rng.uniform(-lim, lim, w.shape).astype(w.dtype))
        else:
            out.append(np.zeros_like(w))
    jm.set_weights(out)
    return jm


def quenched_state(n=512, seed=0, r_cut=2.5, equil=0):
    """A port ``SimState`` on the CPU: a jittered lattice at density 0.4
    quenched under a built-in LJ, thermalized at kT 1.5, then ``equil``
    NVT steps."""
    import hoomd_tf_tpu_torch as htt
    sim = htt.Simulation(dt=0.005, integrator=htt.md.Minimize(0.05),
                         seed=seed, device="cpu")
    sim.init_lattice(n, density=0.4, kT_init=1.5)
    rng = np.random.RandomState(seed)
    sim.state.positions = sim.state.positions + torch.as_tensor(
        0.3 * rng.randn(n, 3).astype(np.float32))
    sim.add_force(htt.md.LennardJones(r_cut=r_cut))
    sim.run(30)
    sim.thermalize_velocities(1.5)
    if equil:
        sim.integrator = htt.md.NVT(kT=1.5, tau=0.5)
        sim.run(equil)
    return sim.state


def on_device(state, device):
    """A copy of a port ``SimState`` with its tensors on ``device``."""
    moved = {f.name: getattr(state, f.name).to(device)
             for f in dataclasses.fields(state)
             if torch.is_tensor(getattr(state, f.name))}
    return dataclasses.replace(state, thermostat={}, **moved)


def train_sim(state, device="cpu", optimizer="adam", lr=1e-2, degree=16,
              r_cut=2.5, weights=None, nlist="cellwise"):
    """NVT at kT 1.5 from ``state`` with a built-in LJ (the labels and the
    driving forces) and the proxy NN attached with ``train=True``; the
    NN's weights are built at the proxy's nodes and set to ``weights``
    when given: ``(sim, tfc, model)``."""
    import hoomd_tf_tpu_torch as htt
    from hoomd_tf_tpu_torch.interop import build_model
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.5, tau=0.5),
                         seed=0, device=device)
    sim.set_state(on_device(state, device))
    sim.add_force(htt.md.LennardJones(r_cut=r_cut))
    model = nn_pair_class()(64, output_forces=False, proxy_degree=degree)
    model.compile(optimizer=optimizer, loss=force_loss, learning_rate=lr)
    build_model(model, r_cut, device)
    if weights is not None:
        model.set_weights(weights)
    tfc = htt.tfcompute(model)
    tfc.attach(sim, r_cut=r_cut, nlist=nlist, train=True)
    return sim, tfc, model


def nlist_with_padding(n=40, nn=12, seed=0):
    """A random ``[n, nn, 4]`` nlist whose rows are zero-padded at random
    lengths, some rows wholly empty."""
    rng = np.random.RandomState(seed)
    nl = rng.uniform(-3, 3, (n, nn, 4)).astype(np.float32)
    nl[..., 3] = rng.randint(0, 3, (n, nn))
    fill = rng.randint(0, nn + 1, n)
    fill[:3] = 0
    for i in range(n):
        nl[i, fill[i]:] = 0.0
    return nl
