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


def k3_inputs(n, L, seed=0, cap=None, unwrap=False, sparse=0.0,
              lattice=False):
    """Cell slots of a random system in a cubic box ``L`` at r_cut 3:
    ``(slots4, counts, pid, grid, cap, lengths), pos4``. ``unwrap`` shifts
    a third of the particles by +-1 and +-2 boxes (positions the binning
    wraps, stored unwrapped); ``sparse`` leaves that share of the box
    empty (empty and half-full cells); ``lattice`` puts them on an exact
    cubic lattice (``n`` a cube), where most distances tie and only the
    candidate slot orders the row."""
    from hoomd_tf_tpu_torch.ops import cell_list
    rng = np.random.RandomState(seed)
    pos = rng.rand(n, 3) * L - L / 2
    if lattice:
        m = round(n ** (1 / 3))
        pos = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                        -1).reshape(-1, 3) + 0.25) * (L / m) - L / 2
    if sparse:
        pos[:, 0] = -L / 2 + (pos[:, 0] + L / 2) * (1 - sparse)
    if unwrap:
        k = rng.randint(-2, 3, (n, 3)) * (rng.rand(n, 1) < 0.34)
        pos = pos + k * L
    pos4 = np.concatenate([pos, rng.randint(0, 3, (n, 1))], 1)
    pos4 = torch.as_tensor(pos4.astype(np.float32))
    grid, c = cell_list.plan(n, [L] * 3, 3.0)
    cap = cap or max(c, cell_list.max_occupancy(np_(pos4), [L] * 3,
                                                grid))
    slots4, counts, pid, _ = cell_list.build_planes(pos4, grid, cap,
                                                    torch.tensor([L] * 3))
    return (slots4, counts, pid, grid, cap, (L, L, L)), pos4


# ---------------------------------------------------------------------------
# tilted and rescaled boxes (the JAX tests' tests/test_triclinic.py helpers)
# ---------------------------------------------------------------------------

#: the JAX tests' tilt factors (tests/test_triclinic.py:20)
TILT = (0.3, -0.2, 0.25)


def cell_matrix(lengths, tilt):
    Lx, Ly, Lz = lengths
    xy, xz, yz = tilt
    return np.array([[Lx, xy * Ly, xz * Lz],
                     [0., Ly, yz * Lz],
                     [0., 0., Lz]])


def tri_positions(n, lengths, tilt, seed=0, lo=None, jitter=0.15):
    """A jittered simple-cubic lattice in fractional space mapped through
    the cell matrix (as tests/test_triclinic.py:28-43)."""
    rng = np.random.RandomState(seed)
    h = cell_matrix(lengths, tilt)
    m = int(np.ceil(n ** (1 / 3)))
    g = (np.arange(m) + 0.5) / m
    frac = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:n]
    frac = frac + rng.uniform(-jitter, jitter, size=frac.shape) / m
    lo = (-np.asarray(lengths) / 2.0) if lo is None else np.asarray(lo)
    return (frac @ h.T + lo).astype(np.float32)


def min_image_27(r, h):
    """The exact minimum image by brute force over the 27 lattice
    translations (valid for |tilt| <= 0.5)."""
    combos = np.array([(i, j, k) for i in (-1, 0, 1)
                       for j in (-1, 0, 1) for k in (-1, 0, 1)])
    shifts = combos @ h.T
    cand = r[..., None, :] + shifts
    idx = np.argmin(np.sum(cand * cand, axis=-1), axis=-1)
    return np.take_along_axis(cand, idx[..., None, None],
                              axis=-2)[..., 0, :]


def numpy_lj_tri(pos, lengths, tilt, r_cut, sigma=1.0):
    """LJ forces ``[n, 3]`` and per-particle energies ``[n]`` (half of
    each pair's) through the 27-image oracle, in float64."""
    pos = np.asarray(pos, np.float64)
    h = cell_matrix(lengths, tilt)
    d = min_image_27(pos[None, :, :] - pos[:, None, :], h)
    rd = np.linalg.norm(d, axis=-1)
    np.fill_diagonal(rd, np.inf)
    mask = rd <= r_cut
    rs = np.where(mask, rd, np.inf)
    s6 = sigma ** 6
    inv6 = s6 * rs ** -6.0
    energy = (0.5 * 4 * (inv6 ** 2 - inv6)).sum(axis=1)
    fmag = 24 * s6 * (2 * s6 * rs ** -13 - rs ** -7)
    forces = -(fmag / np.where(mask, rd, 1.0))[:, :, None] * d
    return np.where(mask[:, :, None], forces, 0.0).sum(axis=1), energy


def geometry_case(kind, device, n=3000, density=0.35, r_cut=2.5,
                  typed=False, rc_matrix=None, seed=7):
    """A fluid packed into a slot layout on ``device`` at one of the
    geometries slice E brings: ``'tilted'`` (the box tilted by
    :data:`TILT`, planned by its perpendicular widths) or ``'scaled'``
    (a dynamic-box layout planned at the fluid's box, as NPT plans it,
    with a 0.15 r_cut minimum skin, then the box and the positions
    rescaled by 0.97 about the center). Returns ``(layout, slot_state,
    aux)``."""
    from hoomd_tf_tpu_torch.md.slots import SlotLayout
    from hoomd_tf_tpu_torch.md.state import init_state
    from hoomd_tf_tpu_torch.ops import box as tbox
    from hoomd_tf_tpu_torch.ops import cellwise as tcw
    types = (np.arange(n) % 2) if typed else None
    if kind == "tilted":
        L = (n / density) ** (1 / 3)
        lengths = np.array([L, L, L])
        pos = tri_positions(n, lengths, TILT, seed=seed)
        lo = -lengths / 2
        box = np.stack([lo, -lo, TILT]).astype(np.float32)
        st = init_state(pos, box, types=types, device=device)
        plan = tcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo,
                                 width_blocks=14, tilt=TILT)
        layout = SlotLayout(plan, n, lo, rc_matrix=rc_matrix,
                            device=device, box=st.box)
    else:
        pos, _, lengths = fluid_arrays(n, density, seed)
        lo = -lengths / 2
        plan = tcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo,
                                 width_blocks=14,
                                 config=tcw.Cellwise(skin=0.15 * r_cut))
        mu = np.float32(0.97)
        box = np.stack([lo * mu, -lo * mu, np.zeros(3)]).astype(np.float32)
        st = init_state(pos * mu, box, types=types, device=device)
        layout = SlotLayout(plan, n, lo, rc_matrix=rc_matrix,
                            device=device, box=st.box, dynamic_box=True)
    slot, aux = layout.pack(st)
    return layout, slot, aux
