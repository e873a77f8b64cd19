"""Port vs JAX package: the slot layout (pack, unpack, rebuild, the Verlet
criterion, ghost pins) on the same numpy inputs. Permutations are integer
maps, so every moved value must be exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hoomd_tf_tpu.md.slots import SlotLayout as JLayout
from hoomd_tf_tpu.ops import cellwise as jcw
from hoomd_tf_tpu_torch.md.slots import SlotLayout as TLayout
from hoomd_tf_tpu_torch.ops import cellwise as tcw

from torch_helpers import fluid_arrays, jax_state, np_, torch_state

FIELDS = ("positions", "velocities", "types", "masses")


def layouts(n=200, density=0.3, seed=5, r_cut=2.5):
    pos, vel, lengths = fluid_arrays(n, density, seed)
    types = np.arange(n) % 3
    js = jax_state(pos, vel, lengths, types=types)
    ts = torch_state(pos, vel, lengths, types=types)
    lo = np.asarray(js.box[0])
    jplan = jcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo)
    tplan = tcw.plan_cellwise(n, lengths, r_cut, positions=pos, lo=lo)
    return (JLayout(jplan, n, lo), js), (TLayout(tplan, n, lo, device="cpu"), ts)


def test_pack_matches_jax():
    (jl, js), (tl, ts) = layouts()
    jss, jaux, _ = jl.pack(js)
    tss, taux = tl.pack(ts)
    for f in FIELDS + ("forces", "virial"):
        np.testing.assert_array_equal(np_(getattr(tss, f)),
                                      np_(getattr(jss, f)), err_msg=f)
    for k in ("valid", "orig", "ref", "occ_max", "vmax", "overflow"):
        np.testing.assert_array_equal(np_(taux[k]), np_(jaux[k]),
                                      err_msg=k)
    assert tss.thermostat["dof"] == float(jss.thermostat["dof"])


def test_pack_unpack_roundtrip():
    _, (tl, ts) = layouts(n=128)
    ts.forces = torch.arange(128 * 4, dtype=torch.float32).reshape(128, 4)
    tss, taux = tl.pack(ts)
    valid = np_(taux["valid"])
    assert np.all(np_(tss.velocities)[valid == 0] == 0)
    np.testing.assert_array_equal(np_(tss.positions)[valid == 0],
                                  np_(tl.centers())[valid == 0])
    back = tl.unpack(tss, taux)
    for f in FIELDS + ("forces",):
        np.testing.assert_array_equal(np_(getattr(back, f)),
                                      np_(getattr(ts, f)), err_msg=f)
    assert "dof" not in back.thermostat


def _drifted(jl, js, tl, ts, scale):
    jss, jaux, _ = jl.pack(js)
    tss, taux = tl.pack(ts)
    rng = np.random.RandomState(9)
    d = scale * rng.uniform(-1, 1, np_(jss.positions).shape)
    d = (d * np_(jaux["valid"])[:, None]).astype(np.float32)
    jss = dataclasses.replace(jss, positions=jss.positions + jnp.asarray(d))
    tss.positions = tss.positions + torch.as_tensor(d)
    return (jss, jaux), (tss, taux)


@pytest.mark.parametrize("scale", [0.01, 0.8])
def test_needs_rebuild_matches(scale):
    (jl, js), (tl, ts) = layouts()
    (jss, jaux), (tss, taux) = _drifted(jl, js, tl, ts, scale)
    want = bool(jl.needs_rebuild(jss, jaux))
    assert bool(tl.needs_rebuild(tss, taux)) == want == (scale > 0.1)


def test_rebuild_matches_jax():
    (jl, js), (tl, ts) = layouts()
    (jss, jaux), (tss, taux) = _drifted(jl, js, tl, ts, 0.8)
    # forces tagged by particle: they must follow their particles
    tag = np_(taux["orig"]).astype(np.float32)
    tss.forces = torch.as_tensor(np.stack([tag] * 4, axis=1))
    jn, jna, _ = jl.rebuild(jss, jaux)
    tn, tna = tl.rebuild(tss, taux)
    for f in FIELDS:
        np.testing.assert_array_equal(np_(getattr(tn, f)),
                                      np_(getattr(jn, f)), err_msg=f)
    for k in ("valid", "orig", "ref", "occ_max", "vmax", "overflow"):
        np.testing.assert_array_equal(np_(tna[k]), np_(jna[k]), err_msg=k)
    assert not np.array_equal(np_(tna["orig"]), np_(taux["orig"]))
    valid = np_(tna["valid"]) > 0
    np.testing.assert_array_equal(np_(tn.forces)[valid, 0],
                                  np_(tna["orig"])[valid])
    assert np.all(np_(tn.forces)[~valid] == 0)


def test_ghost_pin_and_mask_rows():
    _, (tl, ts) = layouts()
    tss, taux = tl.pack(ts)
    tss.positions = tss.positions + 0.1
    tss.velocities = tss.velocities + 1.0
    tss = tl.ghost_pin(tss, taux)
    gh = np_(taux["valid"]) == 0
    np.testing.assert_array_equal(np_(tss.positions)[gh],
                                  np_(tl.centers())[gh])
    assert np.all(np_(tss.velocities)[gh] == 0)
    assert np.all(np_(tss.velocities)[~gh] != 0)
    f, w = tl.mask_rows(torch.ones(len(gh), 4), torch.ones(len(gh), 3, 3),
                        taux)
    assert np.all(np_(f)[gh] == 0) and np.all(np_(w)[~gh] == 1)
