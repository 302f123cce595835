"""The port's D-SHB trainer against the reference's jitted train step.

Both packages start from the same parameters (the reference's init carried
across with ``repro_torch.interop``) and take the same numpy batches; the
port is held to ``repro.training.build_train_step`` step by step, and its
``train_loop`` scan engine to the reference's ``train_loop(engine="scan")``
and to its own loop engine (bit for bit).

Tolerances: per-step loss 1e-5 relative; direction_norm 1e-4 relative;
kappa_hat 1e-4 relative plus 1e-4 absolute; final parameters and momentum
1e-5 of the largest magnitude in the whole tree (the aggregate is one
vector, and its rounding is relative to its global norm, not to each
leaf's: GM's Weiszfeld weights at near-coincident honest rows magnify
fp32 noise into the small bias leaves).  Both run fp32 on the CPU, but
forward/backward reductions and matmuls sum in another order in XLA and
in torch, and the steps compound it.  kappa_hat's numerator ||R - mbar||
is a difference of near-equal vectors: once NNM has mixed every honest
row to the honest mean (ALIE with eta=8 lies far from every honest row),
R equals mbar up to fp32 rounding and kappa_hat (~1e-4) is rounding noise,
hence the absolute term.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.types import AggregatorSpec as JSpec
from repro.data import build_heterogeneous as j_hetero
from repro.data import make_classification as j_make_cls
from repro.data import make_lm_corpus as j_corpus
from repro.data import worker_batches as j_batches
from repro.models import build_model as j_build
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_constant
from repro.optim.schedules import cosine as j_cosine
from repro.training import ByzantineConfig as JByz
from repro.training import TrainerConfig as JCfg
from repro.training import build_train_step as j_build_step
from repro.training import init_state as j_init_state
from repro_torch import data as tdata
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.interop import params_from_numpy, params_to_numpy, state_to_numpy
from repro_torch.models import build_model as t_build
from repro_torch.optim import sgd as t_sgd
from repro_torch.optim.schedules import constant as t_constant
from repro_torch.optim.schedules import cosine as t_cosine
from repro_torch.training import ByzantineConfig as TByz
from repro_torch.training import TrainerConfig as TCfg
from repro_torch.training import build_train_step as t_build_step
from repro_torch.training import init_state as t_init_state
from repro_torch.training.trainer import to_device
from repro_torch.tree import tree_leaves as t_leaves

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _run_both(j_loss, t_loss, params_np, batches, *, rule, pre, attack, eta,
              f, lr_j, lr_t, steps, backends=("xla", "auto"), **spec_kw):
    """Steps both packages on the same batches; returns per-step metric
    pairs and the final parameters of each.  ``spec_kw`` (``hier``,
    ``bucket_size``) goes to both specs; the port is handed the bucket
    permutation the reference draws inside its step."""
    jcfg = JCfg(algorithm="dshb", beta=0.9,
                agg=JSpec(rule=rule, f=f, pre=pre, backend=backends[0],
                          **spec_kw),
                byz=JByz(f=f, attack=attack, eta=eta))
    tcfg = TCfg(algorithm="dshb", beta=0.9,
                agg=TSpec(rule=rule, f=f, pre=pre, backend=backends[1],
                          **spec_kw),
                byz=TByz(f=f, attack=attack, eta=eta))
    n = next(iter(jax.tree_util.tree_leaves(batches[0]))).shape[0]
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jopt, topt = j_sgd(clip=2.0), t_sgd(clip=2.0)
    jstep = jax.jit(j_build_step(j_loss, jopt, jcfg, lr_j))
    tstep = t_build_step(t_loss, topt, tcfg, lr_t)
    jstate = j_init_state(jparams, jopt, n, jcfg)
    tstate = t_init_state(params_from_numpy(params_np, CPU), topt, n, tcfg)
    key = jax.random.PRNGKey(0)
    rows = []
    for b in batches[:steps]:
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, b, sub)
        # The reference's step splits its key and draws the bucket
        # permutation from the first half (training/trainer.py).
        perm = torch.from_numpy(np.array(jax.random.permutation(
            jax.random.split(sub)[0], n)))
        tstate, tm = tstep(tstate, to_device(b, CPU), perm=perm)
        rows.append({k: (float(jm[k]), float(tm[k]))
                     for k in ("loss", "kappa_hat", "direction_norm", "lr")})
    return rows, jstate, tstate


def _check(rows, jstate, tstate):
    for t, r in enumerate(rows):
        assert r["lr"][1] == pytest.approx(r["lr"][0], rel=1e-6), (t, r)
        assert r["loss"][1] == pytest.approx(r["loss"][0], rel=1e-5), (t, r)
        assert r["direction_norm"][1] == pytest.approx(
            r["direction_norm"][0], rel=1e-4), (t, r)
        assert r["kappa_hat"][1] == pytest.approx(
            r["kappa_hat"][0], rel=1e-4, abs=1e-4), (t, r)
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                          jstate["params"]))
    tp = jax.tree_util.tree_leaves(params_to_numpy(tstate["params"]))
    assert len(jp) == len(tp)
    scale = max(float(np.abs(b).max()) for b in jp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)
    # The flat momentum unflattens to the reference's per-leaf list.
    mom = state_to_numpy(tstate)["momentum"]
    jmom = [np.asarray(b) for b in jstate["momentum"]]
    scale = max(float(np.abs(b).max()) for b in jmom)
    for a, b in zip(mom, jmom):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


def _lm_batches(vocab, n_workers, steps, seq=16, batch=2):
    seqs, topics = j_corpus(n_tokens=30_000, vocab=vocab, seq_len=seq + 1,
                            seed=0)
    ds = j_hetero({"seq": seqs, "y": topics}, "y", n_workers, alpha=0.1,
                  seed=0)
    it = j_batches(ds, batch, seed=0)
    out = []
    for _ in range(steps):
        s = next(it)["seq"]
        out.append({"tokens": s[..., :-1], "labels": s[..., 1:]})
    # The port's own numpy copy of the data modules replays the same calls.
    tseqs, ttopics = tdata.make_lm_corpus(n_tokens=30_000, vocab=vocab,
                                          seq_len=seq + 1, seed=0)
    tds = tdata.build_heterogeneous({"seq": tseqs, "y": ttopics}, "y",
                                    n_workers, alpha=0.1, seed=0)
    np.testing.assert_array_equal(next(tdata.worker_batches(tds, batch,
                                                            seed=0))["seq"],
                                  next(j_batches(ds, batch, seed=0))["seq"])
    return out


def test_smollm_reduced_dshb_nnm_cwtm_alie_matches_reference():
    steps, n, f = 3, 8, 2
    jcfg = j_reduced("smollm-360m")
    tcfg = t_reduced("smollm-360m")
    assert (tcfg.num_layers, tcfg.d_model, tcfg.vocab_size) == \
        (jcfg.num_layers, jcfg.d_model, jcfg.vocab_size)
    jmodel, tmodel = j_build(jcfg), t_build(tcfg)
    params_np = jax.tree_util.tree_map(np.asarray,
                                       jmodel.init(jax.random.PRNGKey(0)))
    batches = _lm_batches(jcfg.vocab_size, n, steps)
    rows, jstate, tstate = _run_both(
        jmodel.loss, tmodel.loss, params_np, batches, rule="cwtm", pre="nnm",
        attack="alie", eta=None, f=f, lr_j=j_cosine(0.05, steps, warmup=0),
        lr_t=t_cosine(0.05, steps, warmup=0), steps=steps)
    _check(rows, jstate, tstate)


def test_smollm_reduced_hier_nnm_cwtm_alie_matches_reference():
    """Hierarchical D-SHB: n = 8, f = 2 gives s = 2, 4 buckets, f' = 1."""
    steps, n, f = 3, 8, 2
    jcfg = j_reduced("smollm-360m")
    tcfg = t_reduced("smollm-360m")
    jmodel, tmodel = j_build(jcfg), t_build(tcfg)
    params_np = jax.tree_util.tree_map(np.asarray,
                                       jmodel.init(jax.random.PRNGKey(0)))
    batches = _lm_batches(jcfg.vocab_size, n, steps)
    rows, jstate, tstate = _run_both(
        jmodel.loss, tmodel.loss, params_np, batches, rule="cwtm", pre="nnm",
        attack="alie", eta=None, f=f, lr_j=j_cosine(0.05, steps, warmup=0),
        lr_t=t_cosine(0.05, steps, warmup=0), steps=steps, hier=True)
    _check(rows, jstate, tstate)


# --- the quickstart MLP (examples/quickstart.py's loss and init) ---------

def _mlp_setup(n_workers=8, steps=4):
    x, y = j_make_cls(6000, 10, 32, seed=0)
    ds = j_hetero({"x": x[:4000], "y": y[:4000]}, "y", n_workers, alpha=0.1)
    it = j_batches(ds, 32, seed=1)
    batches = [next(it) for _ in range(steps)]
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"w1": jax.random.normal(k1, (32, 64)) * 0.18,
              "b1": jnp.zeros(64),
              "w2": jax.random.normal(k2, (64, 10)) * 0.12,
              "b2": jnp.zeros(10)}
    return jax.tree_util.tree_map(np.asarray, params), batches


def _j_mlp_loss(p, b):
    h = jax.nn.relu(b["x"] @ p["w1"] + p["b1"])
    lp = jax.nn.log_softmax(h @ p["w2"] + p["b2"])
    return -jnp.take_along_axis(lp, b["y"][:, None].astype(jnp.int32),
                                1).mean(), {}


def _t_mlp_loss(p, b):
    h = torch.relu(b["x"] @ p["w1"] + p["b1"])
    lp = torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1)
    return -torch.gather(lp, 1, b["y"][:, None].long()).mean(), {}


@pytest.mark.parametrize("rule", ["cwtm", "gm"])
def test_quickstart_mlp_matches_reference(rule):
    params_np, batches = _mlp_setup()
    rows, jstate, tstate = _run_both(
        _j_mlp_loss, _t_mlp_loss, params_np, batches, rule=rule, pre="nnm",
        attack="alie", eta=8.0, f=2, lr_j=j_constant(0.3),
        lr_t=t_constant(0.3), steps=len(batches))
    _check(rows, jstate, tstate)


@pytest.mark.parametrize("rule,pre", [("cwtm", "nnm"), ("cwtm", None),
                                      ("gm", "nnm")])
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("xla", "torch")])
def test_quickstart_mlp_hier_matches_reference(rule, pre, backends):
    """The hierarchical step on both backend pairs: the port's "cuda"
    (on the CPU, K6 / K7 and K1-K3's plain versions) against the
    reference's interpret-mode Pallas kernels, and "torch" against
    "xla"."""
    params_np, batches = _mlp_setup(steps=3)
    rows, jstate, tstate = _run_both(
        _j_mlp_loss, _t_mlp_loss, params_np, batches, rule=rule, pre=pre,
        attack="alie", eta=8.0, f=2, lr_j=j_constant(0.3),
        lr_t=t_constant(0.3), steps=len(batches), backends=backends,
        hier=True)
    _check(rows, jstate, tstate)


def test_quickstart_mlp_pre_bucketing_matches_reference():
    params_np, batches = _mlp_setup(steps=3)
    rows, jstate, tstate = _run_both(
        _j_mlp_loss, _t_mlp_loss, params_np, batches, rule="cwtm",
        pre="bucketing", attack="alie", eta=8.0, f=2, lr_j=j_constant(0.3),
        lr_t=t_constant(0.3), steps=len(batches))
    _check(rows, jstate, tstate)


def test_train_loop_draws_bucket_permutations_from_its_seed():
    """train_loop seeds a generator from ``seed``: the same seed gives the
    same run, and a hier step without a permutation source raises."""
    from repro_torch.training import train_loop as t_train_loop
    params_np, batches = _mlp_setup(steps=2)
    cfg = TCfg(algorithm="dshb", beta=0.9,
               agg=TSpec(rule="cwtm", f=2, pre="nnm", hier=True),
               byz=TByz(f=2, attack="alie", eta=8.0))
    runs = [t_train_loop(_t_mlp_loss, params_from_numpy(params_np, CPU),
                         iter(batches), t_sgd(clip=2.0), cfg, t_constant(0.3),
                         steps=1, seed=seed)[1]["history"]["loss"]
            for seed in (4, 4)]
    assert runs[0] == runs[1]
    step = t_build_step(_t_mlp_loss, t_sgd(clip=2.0), cfg, t_constant(0.3))
    state = t_init_state(params_from_numpy(params_np, CPU), t_sgd(clip=2.0),
                         8, cfg)
    with pytest.raises(ValueError, match="Generator or a perm"):
        step(state, to_device(batches[0], CPU))


def test_quickstart_port_reaches_reference_accuracy():
    """examples/quickstart.py run on the port's own train_loop (per-step
    loop, CPU): the same `best acc > 0.8` assert the reference passes."""
    from repro_torch.training import train_loop as t_train_loop
    x, y = tdata.make_classification(6000, 10, 32, seed=0)
    ds = tdata.build_heterogeneous({"x": x[:4000], "y": y[:4000]}, "y", 8,
                                   alpha=0.1)
    xte, yte = torch.from_numpy(x[4000:]), torch.from_numpy(y[4000:])
    params_np, _ = _mlp_setup(steps=0)

    def accuracy(p):
        h = torch.relu(xte @ p["w1"] + p["b1"])
        return (torch.argmax(h @ p["w2"] + p["b2"], -1) == yte).float().mean()

    cfg = TCfg(algorithm="dshb", beta=0.9,
               agg=TSpec(rule="cwtm", f=2, pre="nnm"),
               byz=TByz(f=2, attack="alie", eta=8.0))
    _, out = t_train_loop(_t_mlp_loss, params_from_numpy(params_np, CPU),
                          tdata.worker_batches(ds, 32, seed=1),
                          t_sgd(clip=2.0), cfg, t_constant(0.3), steps=150,
                          eval_fn=accuracy, eval_every=30)
    assert out["best"]["acc"] > 0.8, out["history"]["eval"]


# --- train_loop's scan engine ---------------------------------------------

def _scan_metrics(hist):
    return {k: np.asarray(hist[k], np.float64)
            for k in ("loss", "direction_norm", "kappa_hat")}


def _best_step(hist):
    """The step whose entering iterate Alg. 1 selects: the first strict
    minimum of direction_norm (both engines compare with ``<``)."""
    return int(np.argmin(hist["direction_norm"]))


@pytest.mark.parametrize("model", ["quickstart_mlp", "smollm_reduced"])
def test_train_loop_scan_matches_reference_scan(model):
    """The port's scan-engine train_loop against the reference's, from the
    same numpy params and batches, NNM + CWTM under ALIE: per-step loss,
    direction_norm and kappa_hat within 1e-5 relative (the reference's
    kernel-vs-plain contract), the same eval steps and best step.  ALIE
    at its default eta: at the quickstart's eta = 8, NNM mixes every honest
    row to the honest mean, kappa_hat is fp32 rounding noise (~5e-8) and
    no relative tolerance can hold it (the step tests above add an
    absolute term for that regime)."""
    from repro.training import train_loop as j_train_loop
    from repro_torch.training import train_loop as t_train_loop
    n, f = 8, 2
    if model == "quickstart_mlp":
        steps, eval_every = 6, 3
        params_np, batches = _mlp_setup(steps=steps)
        j_loss, t_loss, eta = _j_mlp_loss, _t_mlp_loss, None
        j_lr, t_lr = j_constant(0.3), t_constant(0.3)
    else:
        steps, eval_every = 4, 2
        jmodel = j_build(j_reduced("smollm-360m"))
        tmodel = t_build(t_reduced("smollm-360m"))
        params_np = jax.tree_util.tree_map(np.asarray,
                                           jmodel.init(jax.random.PRNGKey(0)))
        batches = _lm_batches(j_reduced("smollm-360m").vocab_size, n, steps)
        j_loss, t_loss, eta = jmodel.loss, tmodel.loss, None
        j_lr, t_lr = j_cosine(0.05, steps, warmup=0), t_cosine(0.05, steps,
                                                                warmup=0)
    jcfg = JCfg(algorithm="dshb", beta=0.9,
                agg=JSpec(rule="cwtm", f=f, pre="nnm"),
                byz=JByz(f=f, attack="alie", eta=eta))
    tcfg = TCfg(algorithm="dshb", beta=0.9,
                agg=TSpec(rule="cwtm", f=f, pre="nnm"),
                byz=TByz(f=f, attack="alie", eta=eta))

    def j_eval(p):
        return sum(jnp.sum(jnp.abs(x)) for x in jax.tree_util.tree_leaves(p))

    def t_eval(p):
        return sum(float(torch.sum(torch.abs(x))) for x in t_leaves(p))

    _, jout = j_train_loop(j_loss, jax.tree_util.tree_map(jnp.asarray,
                                                          params_np),
                           iter(batches), j_sgd(clip=2.0), jcfg, j_lr, steps,
                           engine="scan", chunk=2, eval_fn=j_eval,
                           eval_every=eval_every)
    _, tout = t_train_loop(t_loss, params_from_numpy(params_np, CPU),
                           iter(batches), t_sgd(clip=2.0), tcfg, t_lr, steps,
                           engine="scan", chunk=2, eval_fn=t_eval,
                           eval_every=eval_every)
    jm, tm = _scan_metrics(jout["history"]), _scan_metrics(tout["history"])
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=0, err_msg=k)
    assert tout["history"]["eval_step"] == jout["history"]["eval_step"] \
        == list(range(eval_every, steps + 1, eval_every))
    np.testing.assert_allclose(tout["history"]["eval"],
                               jout["history"]["eval"], rtol=1e-5)
    assert _best_step(tout["history"]) == _best_step(jout["history"])
    assert tout["best"]["norm"] == pytest.approx(jout["best"]["norm"],
                                                 rel=1e-5)
    assert tout["scan_report"]["transfers"] == 1
    assert tout["scan_report"]["chunk_shapes"] == \
        jout["scan_report"]["chunk_shapes"]


@pytest.mark.parametrize("spec_kw", [dict(pre="nnm"),
                                     dict(pre="nnm", hier=True),
                                     dict(pre="bucketing")],
                         ids=["nnm", "hier", "bucketing"])
def test_train_loop_scan_equals_loop_bitwise(spec_kw):
    """The port's two engines run one step function on the same batches
    and per-step seeds (the bucket permutations of hier / bucketing
    included): equal histories, params, best iterate and momentum."""
    from repro_torch.obs import runtime as obs_runtime
    from repro_torch.training import train_loop as t_train_loop
    params_np, batches = _mlp_setup(steps=6)
    cfg = TCfg(algorithm="dshb", beta=0.9,
               agg=TSpec(rule="cwtm", f=2, **spec_kw),
               byz=TByz(f=2, attack="alie", eta=8.0))
    outs = {}
    for engine in ("scan", "loop"):
        before = obs_runtime.counters().get("rounds.transfers", 0)
        outs[engine] = t_train_loop(
            _t_mlp_loss, params_from_numpy(params_np, CPU), iter(batches),
            t_sgd(clip=2.0), cfg, t_constant(0.3), 6, seed=5, engine=engine,
            chunk=4, eval_fn=lambda p: p["b2"].sum(), eval_every=3)
        outs[engine][1]["transfers"] = \
            obs_runtime.counters()["rounds.transfers"] - before
    (ps, s), (pl, lp) = outs["scan"], outs["loop"]
    for k in ("loss", "direction_norm", "kappa_hat", "lr", "eval",
              "eval_step"):
        assert s["history"][k] == lp["history"][k], k
    assert s["best"]["norm"] == lp["best"]["norm"]
    for k in ps:
        assert torch.equal(ps[k], pl[k]), k
        assert torch.equal(s["best"]["params"][k], lp["best"]["params"][k]), k
    assert torch.equal(s["state"]["momentum"], lp["state"]["momentum"])
    assert s["state"]["step"] == lp["state"]["step"] == 6
    assert (s["transfers"], lp["transfers"]) == (1, 6)
    # Segments cut at the eval step 3 and at chunk 4: [0, 3), [3, 6).
    assert [(a, b) for a, b, _ in s["scan_report"]["segments"]] == \
        [(0, 3), (3, 6)]


def test_train_loop_checkpoint_requires_scan_engine(tmp_path):
    from repro_torch.rounds import RoundOptions
    from repro_torch.training import train_loop as t_train_loop
    params_np, batches = _mlp_setup(steps=1)
    cfg = TCfg(agg=TSpec(rule="cwtm", f=2, pre="nnm"),
               byz=TByz(f=2, attack="alie", eta=8.0))
    with pytest.raises(ValueError, match="requires engine='scan'"):
        t_train_loop(_t_mlp_loss, params_from_numpy(params_np, CPU),
                     iter(batches), t_sgd(clip=2.0), cfg, t_constant(0.3), 1,
                     engine="loop",
                     options=RoundOptions(checkpoint=str(tmp_path)))
