"""How far three SGD steps of the planes training branch land from the
JAX package's, sharded (4 virtual CPU shards) and unsharded, in float32
and in float64: the report behind ``test_sharded_train_steps_match_jax
[planes]`` (tests/test_torch_parallel_train.py), which holds the planes
kind in float64.

Run from the repository root (CPU only; a few minutes)::

    JAX_PLATFORMS=cpu python tests/planes_gap.py [n_particles]

For each precision it prints the three losses of each engine and the
largest elementwise relative gap of the trained weights: the sharded
port against JAX, the unsharded port against JAX, and the sharded port
against the unsharded one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_parallel_train as tpt  # noqa: E402


def gap(a, b):
    return max(float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300)))
               for x, y in zip(a, b))


def report(n, f64):
    (jsim, jtfc, jm), (tsim, ttfc, tm) = tpt.train_pair_sharded(
        "planes", 4, n=n, f64=f64)
    _, (usim, utfc, um) = tpt.train_pair_sharded("planes", None, n=n,
                                                 f64=f64)
    plan = tsim._ensure_layout().plan
    usim._plan_from_current = lambda: plan
    usim.replan()
    for sim in (jsim, tsim, usim):
        sim.run(3)
    wj, wt, wu = (tpt.trainable(m.get_weights()) for m in (jm, tm, um))
    name = "float64" if f64 else "float32"
    print(f"{name}, {n} particles, plan {plan.grid} cap {plan.capacity}")
    print(f"  losses JAX {jtfc.loss_history}")
    print(f"  losses port, 4 shards {ttfc.loss_history}")
    print(f"  losses port, unsharded {utfc.loss_history}")
    print(f"  weights: 4 shards vs JAX {gap(wt, wj):.3e}, unsharded vs "
          f"JAX {gap(wu, wj):.3e}, 4 shards vs unsharded {gap(wt, wu):.3e}")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    report(n, False)
    jax.config.update("jax_enable_x64", True)
    report(n, True)
