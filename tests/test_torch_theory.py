"""The port's closed forms, kappa-hat estimator and the literal Alg. 2
oracle against the reference (``repro.core.theory``, ``repro.core.nnm``).

* The seven closed forms ported in this slice (``kappa_lower_bound``,
  ``nnm_variance_factor``, ``dgd_bound``, ``dshb_bound``,
  ``dshb_hyperparams``, ``resilience_lower_bound``; plain Python floats)
  equal the reference's on a grid of (n, f) and constants, bit for bit:
  the same formulas in the same order.
* ``empirical_kappa_hat`` (the plain honest mean, with and without
  ``honest_idx``) within 1e-6 relative.
* ``nnm_direct`` within 1e-6 of the reference's on a tie-free stack, and
  within 1e-6 of the port's Gram-space ``nnm`` there.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.core.nnm import nnm_direct as j_nnm_direct
from repro_torch.core import nnm_direct, theory as ttheory
from repro_torch.core.nnm import nnm as t_nnm

GRID = [(n, f) for n in (3, 5, 8, 10, 17, 33) for f in range(0, (n + 1) // 2)
        if n > 2 * f]


@pytest.mark.parametrize("n,f", GRID)
def test_closed_forms_equal_reference(n, f):
    assert ttheory.kappa_lower_bound(n, f) == jtheory.kappa_lower_bound(n, f)
    if f < n:
        assert ttheory.nnm_variance_factor(n, f) == \
            jtheory.nnm_variance_factor(n, f)
    for g_sq in (0.0, 0.5, 3.0):
        assert ttheory.resilience_lower_bound(n, f, g_sq) == \
            jtheory.resilience_lower_bound(n, f, g_sq)
    for kap, g_sq, sig, lsm, gap, steps in itertools.product(
            (0.0, 0.3, 4.0), (0.5, 2.0), (0.0, 1.5), (1.0, 7.0),
            (0.0, 2.5), (1, 100)):
        assert ttheory.dgd_bound(kap, g_sq, lsm, gap, steps) == \
            jtheory.dgd_bound(kap, g_sq, lsm, gap, steps)
        assert ttheory.dshb_bound(kap, g_sq, sig, lsm, gap, n, f, steps) == \
            jtheory.dshb_bound(kap, g_sq, sig, lsm, gap, n, f, steps)
        assert ttheory.dshb_hyperparams(lsm, gap, kap, sig, n, f, steps) == \
            jtheory.dshb_hyperparams(lsm, gap, kap, sig, n, f, steps)


def test_closed_forms_raise_as_reference():
    for fn in ("kappa_lower_bound", "nnm_variance_factor"):
        with pytest.raises(ZeroDivisionError):
            getattr(jtheory, fn)(4, 2 if fn == "kappa_lower_bound" else 4)
        with pytest.raises(ZeroDivisionError):
            getattr(ttheory, fn)(4, 2 if fn == "kappa_lower_bound" else 4)


def _stack(seed, n=9, d=13):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("honest_idx", [None, [0, 2, 3, 5, 6]])
def test_empirical_kappa_hat_equals_reference(honest_idx):
    x = _stack(1)
    agg = np.random.default_rng(2).normal(size=(x.shape[1],)).astype(
        np.float32)
    want = float(jtheory.empirical_kappa_hat(
        jnp.asarray(agg), jnp.asarray(x),
        None if honest_idx is None else jnp.asarray(honest_idx)))
    got = float(ttheory.empirical_kappa_hat(
        torch.from_numpy(agg), torch.from_numpy(x), honest_idx))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("f", [0, 1, 2, 4])
def test_nnm_direct_equals_reference_and_gram_nnm(f):
    x = _stack(3 + f)
    want = np.asarray(j_nnm_direct(jnp.asarray(x), f))
    got = nnm_direct(torch.from_numpy(x), f).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    gram = t_nnm(torch.from_numpy(x), f).numpy()
    np.testing.assert_allclose(got, gram, rtol=0, atol=1e-6 * scale)
