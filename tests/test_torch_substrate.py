"""The port's dense rules, optimizers, schedules, interop and kappa-hat
forms against the JAX reference, on the same numpy inputs.

Tolerance: 1e-5 of the largest magnitude (fp32, sums in another order)
unless stated.  GM / AutoGM after NNM get 1e-4: the mixed rows of
neighbours with the same neighbour set nearly coincide, and Weiszfeld
weights read their distances from the Gram matrix (diag - 2g + diag, a
cancellation), so fp32 noise of ~1e-6 in G becomes ~1e-2 relative noise
in those weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core.types import AggregatorSpec as JSpec
from repro.optim import adam as j_adam
from repro.optim import sgd as j_sgd
from repro.optim import schedules as jsched
from repro.training.trainer import kappa_hat_masked as j_kappa_masked
from repro_torch.core import aggregators as tagg
from repro_torch.core.types import ALL_RULES, AggregatorSpec as TSpec
from repro_torch.interop import (
    params_from_numpy, params_to_numpy, state_from_numpy, state_to_numpy,
)
from repro_torch.optim import adam as t_adam
from repro_torch.optim import sgd as t_sgd
from repro_torch.optim import schedules as tsched
from repro_torch.training import kappa_hat_masked as t_kappa_masked

torch.set_num_threads(2)


def _x(seed, n=17, d=33):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    x[n - 4:] = x[n - 4] + 5.0                   # identical outliers: ties
    return x


@pytest.mark.parametrize("rule", ALL_RULES)
@pytest.mark.parametrize("pre", [None, "nnm"])
def test_dense_aggregate_matches_reference(rule, pre):
    x = _x(1)
    f = 0 if rule == "average" else 4
    want = np.asarray(jagg.aggregate(jnp.asarray(x), JSpec(rule=rule, f=f, pre=pre)))
    got = tagg.aggregate(torch.from_numpy(x), TSpec(rule=rule, f=f, pre=pre)).numpy()
    tol = 1e-4 if pre == "nnm" and rule in ("gm", "autogm") else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("step_decay", (0.5, 7)),
    ("piecewise", (0.1, (3, 9), (0.05, 0.01))),
    ("cosine", (0.05, 40, 5)), ("cosine", (0.2, 13, 0, 0.1))])
def test_schedules_match_reference(name, args):
    jfn, tfn = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in range(0, 45, 3):
        assert tfn(step) == pytest.approx(float(jfn(step)), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_updates_match_reference(opt):
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    dirs = [{k: rng.normal(size=v.shape).astype(np.float32) * 3 for k, v in params.items()}
            for _ in range(3)]
    jo = (j_sgd(clip=2.0, weight_decay=0.01) if opt == "sgd"
          else j_adam(clip=2.0, weight_decay=0.01))
    to = (t_sgd(clip=2.0, weight_decay=0.01) if opt == "sgd"
          else t_adam(clip=2.0, weight_decay=0.01))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params)
    js, ts = jo.init(jp), to.init(tp)
    for d in dirs:
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, d), js, jp, 0.1)
        tp, ts = to.update(params_from_numpy(d), ts, tp, 0.1)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jp.values())
    for k in params:
        np.testing.assert_allclose(params_to_numpy(tp)[k], np.asarray(jp[k]),
                                   rtol=0, atol=1e-5 * scale)


def test_kappa_hat_masked_matches_reference():
    rng = np.random.default_rng(3)
    stack = {"a": rng.normal(size=(8, 3, 2)).astype(np.float32),
             "b": rng.normal(size=(8, 5)).astype(np.float32)}
    agg = {k: v[:5].mean(0) + 0.2 for k, v in stack.items()}
    want = float(j_kappa_masked(jax.tree_util.tree_map(jnp.asarray, agg),
                                jax.tree_util.tree_map(jnp.asarray, stack),
                                jnp.asarray(6)))
    got = float(t_kappa_masked(params_from_numpy(agg), params_from_numpy(stack), 6))
    assert got == pytest.approx(want, rel=1e-5)


def test_interop_round_trips_state_and_bf16():
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "e": np.asarray(jnp.asarray(rng.normal(size=(2, 2)), jnp.bfloat16))}
    mom = [rng.normal(size=(5, 2, 2)).astype(np.float32),
           rng.normal(size=(5, 3, 4)).astype(np.float32)]
    state = {"params": params, "opt_state": (), "step": np.int32(7),
             "momentum": mom}
    ts = state_from_numpy(state)
    assert ts["params"]["e"].dtype == torch.bfloat16
    assert ts["momentum"].shape == (5, 4 + 12)
    back = state_to_numpy(ts)
    assert back["step"] == 7
    np.testing.assert_array_equal(back["params"]["w"], params["w"])
    np.testing.assert_array_equal(back["params"]["e"],
                                  params["e"].astype(np.float32))
    for a, b in zip(back["momentum"], mom):
        np.testing.assert_array_equal(a, b)
