"""The port's lane-dynamic attacks against the JAX reference.

``repro_torch.core.attacks.apply_attack_dyn`` (one lane) and
``apply_attack_batched`` (a lane axis, per-lane family, f and eta) are
held to ``repro.core.attacks.apply_attack_dyn`` / ``apply_attack_batched``
for every family of ``DYN_ATTACK_FAMILIES`` with f in {0, 1, 4}, on the
same numpy stacks; static mimic is held through ``apply_attack_tree``.

Tolerance: 1e-5 of the largest finite magnitude of the reference's
attacked leaf (the moments are fp32 sums in another order); the honest
rows must come back bitwise, NaN / inf positions equal, and mimic must
copy exactly the row the reference copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jattacks
from repro_torch.core import attacks as tattacks

torch.set_num_threads(2)

RTOL = 1e-5
N = 9


def _stack(seed, b=None, n=N):
    rng = np.random.default_rng(seed)
    lead = (n,) if b is None else (b, n)
    return {"w": rng.normal(size=lead + (3, 4)).astype(np.float32),
            "b": (rng.normal(size=lead + (5,)) * 0.2 + 0.1).astype(np.float32)}


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    if fin.any():
        scale = max(float(np.abs(want[fin]).max()), 1e-30)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=RTOL * scale)


def test_family_table_and_ids_match_reference():
    assert tattacks.DYN_ATTACK_FAMILIES == jattacks.DYN_ATTACK_FAMILIES
    for name in jattacks.DYN_ATTACK_FAMILIES + ("lf",):
        assert tattacks.dyn_attack_id(name) == jattacks.dyn_attack_id(name)
    for bad in ("alie_opt", "foe_opt", "bogus"):
        with pytest.raises(ValueError):
            jattacks.dyn_attack_id(bad)
        with pytest.raises(ValueError):
            tattacks.dyn_attack_id(bad)


@pytest.mark.parametrize("f", [0, 1, 4])
@pytest.mark.parametrize("family", jattacks.DYN_ATTACK_FAMILIES)
def test_apply_attack_dyn_matches_reference(family, f):
    stack = _stack(seed=len(family) * 10 + f)
    aid = jattacks.dyn_attack_id(family)
    want = jattacks.apply_attack_dyn(
        jnp.int32(aid), jax.tree_util.tree_map(jnp.asarray, stack),
        jnp.int32(f), eta=jnp.float32(3.0))
    got = tattacks.apply_attack_dyn(
        aid, {k: torch.from_numpy(v.copy()) for k, v in stack.items()},
        torch.tensor(f, dtype=torch.int32), eta=torch.tensor(3.0))
    for k in stack:
        np.testing.assert_array_equal(got[k][:N - f].numpy(), stack[k][:N - f])
        _close(got[k].numpy(), want[k])


def test_apply_attack_batched_matches_reference_per_lane():
    """Eight lanes: every family once plus "lf", per-lane f in {0, 1, 4}
    and per-lane eta, with a NaN honest row in the ALIE lane (the finite-
    masked moments drop it)."""
    names = ("none", "alie", "foe", "sf", "mimic", "nan", "inf", "lf")
    ids = np.array([jattacks.dyn_attack_id(a) for a in names], np.int32)
    fs = np.array([4, 4, 1, 4, 4, 1, 4, 0], np.int32)
    etas = np.linspace(0.5, 8.0, len(names)).astype(np.float32)
    stack = _stack(seed=7, b=len(names))
    stack["w"][1, 0, 1, 2] = np.nan
    want = jattacks.apply_attack_batched(
        jnp.asarray(ids), jax.tree_util.tree_map(jnp.asarray, stack),
        jnp.asarray(fs), etas=jnp.asarray(etas))
    got = tattacks.apply_attack_batched(
        ids.tolist(), {k: torch.from_numpy(v.copy()) for k, v in stack.items()},
        torch.from_numpy(fs), etas=torch.from_numpy(etas))
    for k in stack:
        _close(got[k].numpy(), want[k])
    # The ALIE lane's Byzantine rows stayed finite (the NaN row was masked).
    assert np.isfinite(got["w"][1, N - 4:].numpy()).all()


@pytest.mark.parametrize("f", [1, 4])
def test_static_mimic_matches_reference(f):
    stack = _stack(seed=11 + f)
    want = jattacks.apply_attack_tree(
        "mimic", jax.tree_util.tree_map(jnp.asarray, stack), f)
    got = tattacks.apply_attack_tree(
        "mimic", {k: torch.from_numpy(v.copy()) for k, v in stack.items()}, f)
    for k in stack:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # The trainer's in-place flat form copies the same row.
    flat = torch.cat([torch.from_numpy(stack[k].reshape(N, -1).copy())
                      for k in sorted(stack)], 1)
    tattacks.attack_flat_("mimic", flat, f)
    want_flat = np.concatenate([np.asarray(want[k]).reshape(N, -1)
                                for k in sorted(stack)], 1)
    np.testing.assert_array_equal(flat.numpy(), want_flat)
