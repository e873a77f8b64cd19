"""Chebyshev pair-potential proxy (PyTorch port of
``hoomd_tf_tpu/ops/chebyshev.py``).

A pair potential is one smooth scalar function ``U(r2)`` on
``[r2_lo, r_cut^2]``. The proxy evaluates the model at ``K`` Chebyshev
nodes in ``u = 1/r2``, fits ``K`` coefficients with one ``[K, K]``
constant product, and evaluates every lane by a Clenshaw recurrence.
Below ``r2_lo`` the potential continues C^1-linearly in ``u`` (a finite,
stiffening overlap barrier). The slope series is the analytic Chebyshev
derivative of the energy series, so the proxy force is exactly the
negative gradient of the proxy energy.

Differences from the JAX module, none of them numerical:

- Coefficients are two tensors, ``c`` and ``cd``, each ``[K]`` (typed:
  ``[P, K]`` for the ``P`` unordered type pairs). The JAX lists of ``K``
  scalars exist only for a Pallas closure hoist.
- ``fit`` takes the model's ``pair_energy`` (the nodes need ``U`` only),
  so ordinary autograd reaches the model's parameters through it.
- The node, fit and derivative matrices are made once, on the device the
  proxy is built for: a host-to-device copy in the step loop is a sync.
- ``evaluate.kernel_form(coeffs)`` gives the coefficient table kernel K1
  evaluates (:class:`.cellwise_cuda.ChebForm`).
"""

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["make_pair_proxy", "make_typed_pair_proxy", "clenshaw",
           "proxy_lanes", "type_pairs"]


def _dct_matrix(K):
    """Chebyshev-fit matrix for Gauss-Chebyshev nodes:
    ``c = D @ f(nodes)`` gives interpolation coefficients of degree K-1."""
    k = np.arange(K)
    theta = np.pi * (k + 0.5) / K
    D = np.cos(np.outer(k, theta)) * (2.0 / K)
    D[0] *= 0.5
    return D, np.cos(theta)  # fit matrix, nodes x_k in [-1, 1]


def _diff_matrix(K):
    """Chebyshev differentiation matrix: series coefficients ``c`` of
    ``f(w)`` -> coefficients ``Dd @ c`` of ``df/dw`` (backward recurrence
    ``d_{k-1} = d_{k+1} + 2 k c_k``, ``d_0`` halved)."""
    Dd = np.zeros((K, K))
    for k in range(K - 1, 0, -1):
        prev = Dd[k + 1] if k + 1 < K else np.zeros(K)
        row = prev.copy()
        row[k] += 2.0 * k
        Dd[k - 1] = row
    Dd[0] *= 0.5
    return Dd


def clenshaw(coeffs, w):
    """Evaluate a Chebyshev series at ``w`` (in [-1, 1], any shape).
    ``coeffs[k]`` is a scalar tensor or a tensor broadcastable with
    ``w`` (lane-varying coefficients)."""
    b1 = torch.zeros_like(w)
    b2 = torch.zeros_like(w)
    two_w = 2.0 * w
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = coeffs[k] + two_w * b1 - b2, b1
    return coeffs[0] + w * b1 - b2


def _seq_sum(terms):
    """``terms[0] + terms[1] + ...`` left to right (the JAX
    ``sum(list[1:], list[0])`` order, which the kernel repeats)."""
    out = terms[0]
    for k in range(1, len(terms)):
        out = out + terms[k]
    return out


def proxy_lanes(c, cd, r2, mid, inv_half, u_hi):
    """``(U, dU/dr2)`` per lane from per-term coefficients ``c[k]``,
    ``cd[k]`` (scalars or lane tensors) -- the proxy's lane form, shared
    with kernel K1's plain version."""
    U_hi_edge = _seq_sum(c)          # series value at w = 1 (u = u_hi)
    s_hi = _seq_sum(cd)
    u = 1.0 / r2
    over = torch.clamp_min(u - u_hi, 0.0)
    w = torch.clamp((u - mid) * inv_half, -1.0, 1.0)
    su = clenshaw(cd, w)
    in_range = over <= 0.0
    # C^1 linear-in-u continuation past u_hi (the overlap barrier)
    U = torch.where(in_range, clenshaw(c, w), U_hi_edge + s_hi * over)
    su = torch.where(in_range, su, s_hi)
    return U, -su * u * u


def type_pairs(n_types):
    """The unordered type pairs ``(a, b)``, ``a <= b``, in table order."""
    return [(a, b) for a in range(n_types) for b in range(a, n_types)]


def make_pair_proxy(degree, r2_lo, r2_hi, dtype=None, device=None):
    """``(fit, evaluate)`` of the Chebyshev pair proxy over ``u = 1/r2``
    on ``[r2_lo, r2_hi]``.

    ``fit(pair_energy) -> {"c": [K], "cd": [K]}`` evaluates the pair
    energy at the K nodes (differentiable in whatever ``pair_energy``
    reads). ``evaluate(coeffs, r2) -> (U, dU/dr2)`` is the lane form.

    :param degree: number of Chebyshev terms K.
    :param r2_lo: inner edge of the fit range.
    :param r2_hi: outer edge (``r_cut**2``).
    :param dtype: node and coefficient dtype (default float32).
    :param device: where the node and matrix constants live (default: the
        CUDA card; pass ``device="cpu"`` for the CPU).
    """
    K = int(degree)
    fit_dtype = torch.float32 if dtype is None else dtype
    u_lo, u_hi = 1.0 / float(r2_hi), 1.0 / float(r2_lo)
    mid, half = 0.5 * (u_hi + u_lo), 0.5 * (u_hi - u_lo)
    D, x = _dct_matrix(K)
    u_nodes = mid + half * x
    inv_half = 1.0 / half
    # slope series = d(energy series)/du (dw/du = 1/half)
    Dd = _diff_matrix(K) * inv_half
    kw = dict(dtype=fit_dtype, device=resolve_device(device,
                                                     "make_pair_proxy"))
    r2_nodes = torch.as_tensor(1.0 / u_nodes, **kw)
    D_t = torch.as_tensor(D, **kw)
    Dd_t = torch.as_tensor(Dd, **kw)

    def fit(pair_energy):
        U_k = pair_energy(r2_nodes)
        c = D_t @ U_k.to(fit_dtype)
        return {"c": c, "cd": Dd_t @ c}

    def lanes(c, cd, r2):
        return proxy_lanes(c, cd, r2, mid, inv_half, u_hi)

    def evaluate(coeffs, r2):
        return lanes(coeffs["c"], coeffs["cd"], r2)

    evaluate.basis = {"K": K, "mid": float(mid),
                      "inv_half": float(inv_half), "u_hi": float(u_hi),
                      "pairs": None}
    evaluate.lanes = lanes
    evaluate.kernel_form = lambda coeffs: _cheb_form(evaluate.basis,
                                                     coeffs)
    return fit, evaluate


def make_typed_pair_proxy(degree, r2_lo, r2_hi, n_types, dtype=None,
                          device=None):
    """Typed variant of :func:`make_pair_proxy`: one coefficient set per
    unordered type pair, fitted from ``pair_energy(r2, ti, tj)`` (which
    must be symmetric under type swap). ``fit`` returns ``{"c": [P, K],
    "cd": [P, K]}`` in :func:`type_pairs` order; ``evaluate(coeffs, r2,
    ti, tj)`` blends each lane's coefficients by type-pair masks (types
    outside the table get zero coefficients)."""
    K = int(degree)
    pairs = type_pairs(int(n_types))
    fit_u, eval_u = make_pair_proxy(
        degree, r2_lo, r2_hi, dtype=dtype,
        device=resolve_device(device, "make_typed_pair_proxy"))

    def fit(pair_energy):
        cs, cds = [], []
        for a, b in pairs:
            def energy(r2, a=a, b=b):
                return pair_energy(r2, torch.full_like(r2, float(a)),
                                   torch.full_like(r2, float(b)))
            co = fit_u(energy)
            cs.append(co["c"])
            cds.append(co["cd"])
        return {"c": torch.stack(cs), "cd": torch.stack(cds)}

    def evaluate(coeffs, r2, ti, tj):
        masks = []
        for a, b in pairs:
            m = (ti == float(a)) & (tj == float(b))
            if a != b:
                m = m | ((ti == float(b)) & (tj == float(a)))
            masks.append(m.to(r2.dtype))
        zero = torch.zeros_like(r2)

        def blend(tab):
            out = []
            for k in range(K):
                acc = zero
                for p, m in enumerate(masks):
                    acc = acc + m * tab[p, k]
                out.append(acc)
            return out

        return eval_u.lanes(blend(coeffs["c"]), blend(coeffs["cd"]), r2)

    evaluate.basis = dict(eval_u.basis, pairs=tuple(pairs))
    evaluate.kernel_form = lambda coeffs: _cheb_form(evaluate.basis,
                                                     coeffs)
    return fit, evaluate


def _cheb_form(basis, coeffs):
    from .cellwise_cuda import ChebForm
    return ChebForm(basis, coeffs)
