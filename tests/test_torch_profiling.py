"""The port's profiling helpers on the CPU (``utils.profiling``): a trace
of a CPU run is written and names an op, and ``time_steps`` and
``benchmark_simulation`` return the JAX package's keys."""

import json
import math

import pytest
import torch

import hoomd_tf_tpu_torch as htt
from hoomd_tf_tpu_torch.utils import profiling

JAX_TIME_KEYS = {"ms_per_step", "steps_per_s", "all_runs_s"}
JAX_BENCH_KEYS = {"steps", "rounds", "mean_s", "min_s", "stddev_s",
                  "steps_per_s"}


class LJ(htt.SimModel):
    def compute(self, nlist, positions, box):
        rinv = htt.nlist_rinv(nlist)
        inv_r6 = rinv ** 6
        energy = torch.sum(2.0 * (inv_r6 * inv_r6 - inv_r6), dim=1)
        return htt.compute_nlist_forces(nlist, energy)


def small_sim():
    sim = htt.Simulation(dt=0.005, integrator=htt.md.NVT(kT=1.2, tau=0.5),
                         seed=1, device="cpu")
    sim.init_lattice(64, density=0.4, kT_init=1.2)
    htt.tfcompute(LJ(32)).attach(sim, r_cut=3.0)
    return sim


def test_jax_keys():
    """The JAX package's helpers return these keys (read from its
    source, which imports JAX)."""
    import inspect
    from hoomd_tf_tpu.utils import profiling as jprof
    src = inspect.getsource(jprof)
    for k in JAX_TIME_KEYS | JAX_BENCH_KEYS:
        assert f'"{k}"' in src


def test_trace_cpu_names_an_op(tmp_path):
    sim = small_sim()
    sim.run(5)
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        sim.run(5)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


def test_trace_defaults_to_the_card(tmp_path):
    """Without a device the trace is of a run on the card, and a machine
    without one raises, as every entry point does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path)):
            pass


def test_time_steps_keys():
    sim = small_sim()
    r = profiling.time_steps(sim, 10, reps=2)
    assert set(r) == JAX_TIME_KEYS
    assert len(r["all_runs_s"]) == 2
    assert r["ms_per_step"] > 0 and r["steps_per_s"] > 0
    assert math.isclose(r["ms_per_step"] * r["steps_per_s"], 1000.0,
                        rel_tol=1e-12)
    assert sim.state.step == 30


def test_benchmark_simulation_keys():
    sim = small_sim()
    r = htt.utils.benchmark_simulation(sim, steps=10, equilibration=5,
                                       reps=2)
    assert set(r) == JAX_BENCH_KEYS
    assert (r["steps"], r["rounds"]) == (10, 2)
    assert r["min_s"] <= r["mean_s"]
    assert math.isclose(r["steps_per_s"], 10 / r["min_s"])
    assert sim.state.step == 5 + 30
