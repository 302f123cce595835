"""Selective robustness (``TrainerConfig.fsdp_keys``) and the launch-time
config helpers of the port, against the reference on the CPU.

One train step of each reduced attention-family arch (n = 4, f = 1, ALIE,
NNM + CWTM) runs in both packages from the same parameters (the
reference's init carried across, QKV biases made random) and the same
numpy batch.  Params, the (robust) momentum and the metrics are held to
the reference's jitted step within 1e-5 of the largest magnitude (of the
whole tree for params and momentum; a scalar metric is its own
magnitude): both sum fp32 products in another order.  The FSDP leaves'
direction is the mean over workers of the per-worker gradients in the
port and the gradient of the mean loss in the reference, which differ
only in fp32 summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.core.types import AggregatorSpec as JSpec
from repro.launch import launch_config as j_lc
from repro.models import build_model as j_build
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_constant
from repro.training import ByzantineConfig as JByz
from repro.training import TrainerConfig as JCfg
from repro.training import build_train_step as j_build_step
from repro.training import init_state as j_init_state
from repro.training.trainer import split_params as j_split
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.interop import (
    params_from_numpy, params_to_numpy, state_from_numpy, state_to_numpy,
)
from repro_torch.launch import launch_config as t_lc
from repro_torch.models import build_model as t_build
from repro_torch.optim import sgd as t_sgd
from repro_torch.optim.schedules import constant as t_constant
from repro_torch.training import ByzantineConfig as TByz
from repro_torch.training import TrainerConfig as TCfg
from repro_torch.training import build_train_step as t_build_step
from repro_torch.training import init_state as t_init_state
from repro_torch.training import merge_params, split_params, train_loop
from repro_torch.training.trainer import _split_info, to_device
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(2)
CPU = torch.device("cpu")
TOL = 1e-5
N, F, B, S = 4, 1, 2, 32
FSDP_KEYS = t_lc.FSDP_KEYS
NEW_ARCHS = ("qwen2-7b", "codeqwen1.5-7b", "minitron-8b", "mixtral-8x22b",
             "arctic-480b", "internvl2-2b")


def _params(arch: str, seed: int = 0):
    """The reduced config's reference init as numpy, QKV biases random."""
    jcfg = j_reduced(arch)
    jmodel = j_build(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(seed)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = params["blocks"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = (0.5 * rng.standard_normal(attn[k].shape)).astype(np.float32)
    return jcfg, jmodel, params


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    s = S - cfg.num_patches if cfg.family == "vlm" else S
    tokens = rng.integers(0, cfg.vocab_size, (N, B, s + 1)).astype(np.int32)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (N, B, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return batch


def _configs(algorithm: str, fsdp_keys: tuple):
    kw = dict(algorithm=algorithm, beta=0.9, fsdp_keys=fsdp_keys)
    return (JCfg(agg=JSpec(rule="cwtm", f=F, pre="nnm", backend="xla"),
                 byz=JByz(f=F, attack="alie"), **kw),
            TCfg(agg=TSpec(rule="cwtm", f=F, pre="nnm"),
                 byz=TByz(f=F, attack="alie"), **kw))


def _close(got, want, what: str, scale=None) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _tree_close(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"{what}[{i}]", scale)


def _step_both(arch: str, algorithm: str, fsdp_keys: tuple):
    jcfg, jmodel, params = _params(arch)
    tmodel = t_build(t_reduced(arch))
    batch = _batch(jcfg)
    jtc, ttc = _configs(algorithm, fsdp_keys)
    jopt, topt = j_sgd(clip=2.0), t_sgd(clip=2.0)
    jstep = jax.jit(j_build_step(jmodel.loss, jopt, jtc, j_constant(0.05)))
    tstep = t_build_step(tmodel.loss, topt, ttc, t_constant(0.05))
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, params), jopt,
                          N, jtc)
    tstate = t_init_state(params_from_numpy(params, CPU), topt, N, ttc)
    jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, to_device(batch, CPU))
    return params, jstate, jm, tstate, tm


def _check_step(params, jstate, jm, tstate, tm, fsdp_keys) -> None:
    for k in ("loss", "direction_norm", "kappa_hat", "lr"):
        _close(float(tm[k]), float(jm[k]), k)
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                          jstate["params"]))
    tp = tree_leaves(params_to_numpy(tstate["params"]))
    _tree_close(tp, jp, "params")
    # Every leaf moved, robust and FSDP alike.
    for a, b in zip(tp, tree_leaves(params)):
        assert np.abs(a - np.asarray(b)).max() > 0
    if "momentum" in jstate:
        jmom = [np.asarray(m) for m in jstate["momentum"]]
        _tree_close(state_to_numpy(tstate, fsdp_keys)["momentum"], jmom,
                    "momentum")
    else:
        assert "momentum" not in tstate


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_dshb_step_matches_reference(arch):
    """One NNM + CWTM D-SHB step of each reduced config, every leaf robust."""
    out = _step_both(arch, "dshb", ())
    _check_step(*out, ())


@pytest.mark.parametrize("algorithm", ["dshb", "dgd"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_fsdp_step_matches_reference(arch, algorithm):
    """fsdp_keys = FSDP_KEYS: the experts take the mean gradient, the rest
    (routers and arctic's dense residual too) the robust path."""
    out = _step_both(arch, algorithm, FSDP_KEYS)
    params, jstate, _, tstate, _ = out
    _check_step(*out, FSDP_KEYS)
    if algorithm == "dshb":
        robust, fsdp = split_params(tstate["params"], FSDP_KEYS)
        assert tstate["momentum"].shape == (N, sum(p.numel() for p in robust))
        assert len(fsdp) == 3 and len(jstate["momentum"]) == len(robust)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_split_paths_match_reference_keystr(arch):
    """The key paths are jax's keystr strings in jax's leaf order; the
    experts match FSDP_KEYS, every router and arctic's
    ['moe']['dense'] residual stay robust."""
    _, _, params = _params(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    jpaths = [jax.tree_util.keystr(p) for p, _ in flat]
    tparams = params_from_numpy(params, CPU)
    _, paths, is_fsdp = _split_info(tparams, FSDP_KEYS)
    assert paths == tree_paths(tparams) == jpaths
    fsdp = [p for p, f in zip(paths, is_fsdp) if f]
    assert fsdp == ["['blocks']['moe']['wg']", "['blocks']['moe']['wi']",
                    "['blocks']['moe']['wo']"]
    robust = [p for p, f in zip(paths, is_fsdp) if not f]
    assert "['blocks']['moe']['router']" in robust
    if arch == "arctic-480b":
        assert {"['blocks']['moe']['dense']['wi']",
                "['blocks']['moe']['dense']['wg']",
                "['blocks']['moe']['dense']['wo']"} <= set(robust)
    jr, jf = j_split(params, FSDP_KEYS)
    tr, tf = split_params(tparams, FSDP_KEYS)
    assert [a.shape for a in jr] == [tuple(a.shape) for a in tr]
    assert [a.shape for a in jf] == [tuple(a.shape) for a in tf]


def test_split_merge_round_trip():
    _, _, params = _params("arctic-480b")
    tparams = params_from_numpy(params, CPU)
    skeleton, _, is_fsdp = _split_info(tparams, FSDP_KEYS)
    robust, fsdp = split_params(tparams, FSDP_KEYS)
    back = merge_params(robust, fsdp, skeleton, is_fsdp)
    assert tree_paths(back) == tree_paths(tparams)
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(tparams)))
    # No key: every leaf robust.
    robust, fsdp = split_params(tparams, ())
    assert fsdp == [] and len(robust) == len(tree_leaves(tparams))


def test_fsdp_selective_robustness_equivalence():
    """The reference's test on the port: with attack = none and the
    average, the FSDP mean gradients equal the robust average."""
    n, d = 6, 5
    rng = np.random.default_rng(3)
    centers = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))

    def loss_fn(params, batch):
        c = centers[batch["idx"][0]]
        pred = params["a"] + params["b"]
        return 0.5 * torch.sum((pred - c) ** 2), {}

    base = dict(algorithm="dgd", agg=TSpec(rule="average", f=0, pre=None),
                byz=TByz(f=0, attack="none"))
    batch = {"idx": torch.arange(n)[:, None]}
    outs = []
    for fsdp in ((), ("['b']",)):
        cfg = TCfg(**base, fsdp_keys=fsdp)
        optimizer = t_sgd()
        step_fn = t_build_step(loss_fn, optimizer, cfg, t_constant(0.5))
        params = {"a": torch.zeros(d), "b": torch.zeros(d)}
        state = t_init_state(params, optimizer, n, cfg)
        state, _ = step_fn(state, batch)
        outs.append(params_to_numpy(state["params"]))
    np.testing.assert_allclose(outs[0]["a"], outs[1]["a"], rtol=1e-5)
    np.testing.assert_allclose(outs[0]["b"], outs[1]["b"], rtol=1e-5)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_train_loop_scan_equals_loop_with_fsdp(arch):
    _, _, params = _params(arch)
    model = t_build(t_reduced(arch))
    cfg = TCfg(agg=TSpec(rule="cwtm", f=F, pre="nnm"),
               byz=TByz(f=F, attack="alie"), fsdp_keys=FSDP_KEYS)
    batches = [_batch(model.cfg, seed) for seed in range(3)]
    outs = {}
    for engine in ("scan", "loop"):
        final, out = train_loop(model.loss, params_from_numpy(params, CPU),
                                iter(batches), t_sgd(clip=2.0), cfg,
                                t_constant(0.05), 3, engine=engine)
        outs[engine] = (final, out)
    (fs, os_), (fl, ol) = outs["scan"], outs["loop"]
    for a, b in zip(tree_leaves(fs), tree_leaves(fl)):
        assert torch.equal(a, b)
    assert torch.equal(os_["state"]["momentum"], ol["state"]["momentum"])
    for k in ("loss", "direction_norm", "kappa_hat"):
        assert os_["history"][k] == ol["history"][k], k
    assert os_["best"]["norm"] == ol["best"]["norm"]


def test_state_round_trips_with_fsdp():
    """A reference D-SHB state with FSDP_KEYS (momentum over the robust
    leaves only) -> the port -> back, exactly; the wrong keys refuse."""
    _, _, params = _params("mixtral-8x22b")
    jtc, _ = _configs("dshb", FSDP_KEYS)
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, params),
                          j_sgd(), N, jtc)
    rng = np.random.default_rng(5)
    jstate["momentum"] = [rng.standard_normal(m.shape).astype(np.float32)
                          for m in jstate["momentum"]]
    state = jax.tree_util.tree_map(np.asarray, jstate)
    ts = state_from_numpy(state, CPU, fsdp_keys=FSDP_KEYS)
    robust, _ = split_params(ts["params"], FSDP_KEYS)
    assert ts["momentum"].shape == (N, sum(p.numel() for p in robust))
    back = state_to_numpy(ts, fsdp_keys=FSDP_KEYS)
    assert len(back["momentum"]) == len(state["momentum"])
    for a, b in zip(back["momentum"], state["momentum"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(state["params"])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="robust leaves"):
        state_from_numpy(state, CPU)


def test_moe_params_carry_in_their_own_dtypes():
    """A bf16 MoE tree: the router stays fp32, the (L, E, d, ff) expert
    stacks and the rest bf16, bit for bit both ways."""
    cfg = j_reduced("arctic-480b").replace(dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(
        np.asarray, j_build(cfg).init(jax.random.PRNGKey(1)))
    tp = params_from_numpy(params, CPU)
    moe = tp["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi"].dtype == torch.bfloat16
    assert tuple(moe["wi"].shape) == (cfg.num_layers, cfg.num_experts,
                                      cfg.d_model, cfg.d_ff)
    assert moe["dense"]["wi"].dtype == torch.bfloat16
    back = params_to_numpy(tp)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_config_matches_reference(arch):
    """Every function, for every arch the port registers, at each shape."""
    tcfg, jcfg = t_get(arch), j_get(arch)
    assert t_lc.expert_param_count(tcfg) == j_lc.expert_param_count(jcfg)
    assert t_lc.wants_fsdp_experts(tcfg) == j_lc.wants_fsdp_experts(jcfg)
    assert t_lc.fsdp_keys_for(tcfg) == j_lc.fsdp_keys_for(jcfg)
    assert t_lc.FSDP_KEYS == j_lc.FSDP_KEYS
    assert t_lc.FSDP_EXPERT_THRESHOLD == j_lc.FSDP_EXPERT_THRESHOLD
    assert t_lc.LONG_CONTEXT_WINDOW == j_lc.LONG_CONTEXT_WINDOW
    for shape in SHAPES:
        assert t_lc.skip_reason(arch, shape) == j_lc.skip_reason(arch, shape)
        got, want = t_lc.launch_config(arch, shape), j_lc.launch_config(arch, shape)
        assert (got.remat, got.sliding_window) == (want.remat, want.sliding_window)
        assert got.replace(remat=False, sliding_window=None) == \
            tcfg.replace(remat=False, sliding_window=None)


def test_fsdp_keys_come_from_the_full_config():
    """Mixtral's 56 layers pass the threshold; one layer does not: a
    caller cutting depth must ask fsdp_keys_for of the full config."""
    full = t_get("mixtral-8x22b")
    assert t_lc.expert_param_count(full) == 3.0 * 8 * 6144 * 16384 * 56
    assert t_lc.fsdp_keys_for(full) == FSDP_KEYS
    assert t_lc.fsdp_keys_for(full.replace(num_layers=1)) == ()
    assert t_lc.fsdp_keys_for(t_get("arctic-480b")) == FSDP_KEYS
    assert t_lc.fsdp_keys_for(t_get("qwen2-7b")) == ()
    for arch in ("rwkv6-3b", "zamba2-2.7b", "whisper-base"):
        assert t_lc.fsdp_keys_for(t_get(arch)) == ()
