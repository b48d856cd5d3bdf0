"""The parity contract between the PyTorch port and the JAX package, as
helpers for the ``test_torch_*`` files.

* Integer results match bit for bit.
* Over short sweeps x agrees at rtol 2e-4, at least 95% of rows agree bit
  for bit, and every row that differs traces to an accept decision within
  float32 rounding of its threshold.
* The carried f agrees at rtol 2e-3.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import objective_math as om
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rng as trng


def _flip_margin_ok(x_prev, kid, T, seed, cidx, step, variant):
    """At the step whose accept decision differs, the decision must sit
    within float32 rounding of its threshold: recompute it in float64."""
    dim = x_prev.shape[0]
    rbits, uval, uacc = trng.draws3(seed, torch.tensor([cidx]), step)
    d = int(rbits[0]) % dim
    lo, _, width = om.box_f32(kid)
    x0 = torch.as_tensor(x_prev, dtype=torch.float64)[None]
    x1 = x0.clone()
    x1[0, d] = float(tref.proposal(lo, width, uval))
    f0 = float(om.full_eval(kid, x0, dim))
    f1 = float(om.full_eval(kid, x1, dim))
    arg = -(f1 - f0) / T
    # float32 evaluation error of f, scaled by the terms summed, over T;
    # the delta variant's carried accumulators add a few more roundings.
    scale = dim * (abs(f0) + abs(f1) + 1.0) * (2 if variant == "delta" else 1)
    tol = 8 * scale * 2.0 ** -24 / T + 2.0 ** -20
    u = float(uacc[0])
    if u <= 0.0 or arg > 80 or arg < -80:
        return False
    return abs(math.log(u) - arg) <= tol


def assert_sweep_parity(x0, port, ref, *, kid, T, seed, step0, cidx,
                        variant, n_steps):
    """``port(k)`` and ``ref(k)`` run k steps of one sweep from x0 and
    return (x, f).  ``kid``, ``T``, ``seed``, ``step0``, ``cidx`` are
    per-row arrays (the expanded controls)."""
    x0 = np.asarray(x0)
    xp, fp = (np.asarray(a) for a in port(n_steps))
    xr, fr = (np.asarray(a) for a in ref(n_steps))
    same = (xp == xr).all(axis=1)
    assert same.mean() >= 0.95, f"only {same.mean():.3f} of rows bit-equal"
    # Rows within rtol 2e-4 agree; a row beyond it took another accept
    # decision somewhere, and must trace to a near-threshold one.
    close = np.isclose(xp, xr, rtol=2e-4, atol=2e-4).all(axis=1)
    np.testing.assert_allclose(fp[close], fr[close], rtol=2e-3, atol=2e-3)
    rows = np.flatnonzero(~close)
    if len(rows):
        _assert_rows_trace_to_flips(rows, x0, port, ref, kid, T, seed, step0,
                                    cidx, variant, n_steps)


def _assert_rows_trace_to_flips(rows, x0, port, ref, kid, T, seed, step0,
                                cidx, variant, n_steps):
    """Replay the whole batch for 1..n_steps steps on both sides (a
    reduction may round differently at another row count); at the first
    step where a differing row parts, its accept decision must be a
    near-threshold one."""
    pending = {int(r): x0[r] for r in rows}
    for k in range(1, n_steps + 1):
        xp_k = np.asarray(port(k)[0])
        xr_k = np.asarray(ref(k)[0])
        for r in [r for r in pending if not (xp_k[r] == xr_k[r]).all()]:
            assert _flip_margin_ok(pending.pop(r), int(kid[r]), float(T[r]),
                                   int(seed[r]), int(cidx[r]),
                                   (int(step0[r]) + k - 1) & 0xFFFFFFFF,
                                   variant), (
                f"row {r} diverged at step {k - 1} on a decision far from "
                "its threshold")
        for r in pending:
            pending[r] = xp_k[r]
    assert not pending, f"rows {sorted(pending)} differ but replay identically"
