"""The D-SHB trainer under ``worker_axes`` on a 2-rank gloo world of CPU
processes, held to the reference's jitted single-device step and to the
port's single-process step.

Each rank builds the step with ``TrainerConfig(worker_axes=("shard",))``
inside ``launch.mesh.use_mesh``: it computes the gradients of half the
workers, reshards every round's rows to its column block, keeps the
momentum and the attacked copy as that block, aggregates through
"cuda_sharded" / "cuda_hier" and applies the gathered direction to its own
copy of the parameters.  One spawn (hard time limit) runs every case and
returns each rank's metrics and parameters:

* reduced smollm-360m, n = 8, f = 2, ALIE, NNM + CWTM on "cuda_sharded"
  and hier + NNM + CWTM on "cuda_hier" (s = 2), 2 steps, against the
  reference's jitted step (tests/test_torch_trainer.py's tolerances:
  loss 1e-5, direction_norm and kappa_hat 1e-4, parameters 1e-5 of the
  tree's largest magnitude);
* the quickstart MLP under the families whose sums cross the column
  blocks (mimic's honest Gram, ALIE's finite-row masks with a NaN worker,
  foe_opt / alie_opt's damages), D-GD, the sketch Gram, the taps and
  ``fsdp_keys`` (the FSDP leaf's gradient sums all-reduced over the world),
  against the port's own single-process step at the same tolerances, the
  taps at 1e-5 (trim_frac exactly);
* the two ranks' parameters equal bit for bit after every case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.types import AggregatorSpec as JSpec
from repro.data import build_heterogeneous as j_hetero
from repro.data import make_lm_corpus as j_corpus
from repro.data import worker_batches as j_batches
from repro.models import build_model as j_build
from repro.optim import sgd as j_sgd
from repro.optim.schedules import cosine as j_cosine
from repro.training import ByzantineConfig as JByz
from repro.training import TrainerConfig as JCfg
from repro.training import build_train_step as j_build_step
from repro.training import init_state as j_init_state
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as t_build
from repro_torch.optim import sgd as t_sgd
from repro_torch.optim.schedules import constant as t_constant
from repro_torch.optim.schedules import cosine as t_cosine
from repro_torch.training import ByzantineConfig as TByz
from repro_torch.training import TrainerConfig as TCfg
from repro_torch.training import build_train_step as t_build_step
from repro_torch.training import init_state as t_init_state
from repro_torch.training.trainer import to_device

CPU = torch.device("cpu")
N, F, STEPS = 8, 2, 2
WORLD_LIMIT = 300

#: (tag, model, TrainerConfig kwargs, spec kwargs, reference?)
CASES = (
    ("smollm/nnm+cwtm", "smollm", dict(), dict(rule="cwtm", pre="nnm",
                                               backend="cuda_sharded"), True),
    ("smollm/hier+nnm+cwtm", "smollm", dict(),
     dict(rule="cwtm", pre="nnm", hier=True, backend="cuda_hier"), True),
    ("mlp/mimic+nnm+cwtm", "mlp", dict(attack="mimic"),
     dict(rule="cwtm", pre="nnm", backend="cuda_sharded"), False),
    ("mlp/nan+cwtm", "mlp", dict(attack="nan"),
     dict(rule="cwtm", pre=None, backend="cuda_sharded"), False),
    ("mlp/foe_opt+nnm+gm", "mlp", dict(attack="foe_opt"),
     dict(rule="gm", pre="nnm", backend="cuda_sharded"), False),
    ("mlp/alie_opt+hier+cwtm", "mlp", dict(attack="alie_opt"),
     dict(rule="cwtm", pre="nnm", hier=True, bucket_size=2,
          backend="cuda_hier"), False),
    ("mlp/dgd+krum", "mlp", dict(algorithm="dgd"),
     dict(rule="krum", pre="nnm", backend="cuda_sharded"), False),
    ("mlp/sketch+nnm+cwtm", "mlp", dict(),
     dict(rule="cwtm", pre="nnm", sketch_dim=16, backend="cuda_sharded"),
     False),
    ("mlp/taps+nnm+cwtm", "mlp", dict(taps=True),
     dict(rule="cwtm", pre="nnm", backend="cuda_sharded"), False),
    ("mlp/fsdp+nnm+cwtm", "mlp", dict(fsdp_keys=("['w1']",)),
     dict(rule="cwtm", pre="nnm", backend="cuda_sharded"), False),
)


def _lm_batches(vocab: int) -> list:
    seqs, topics = j_corpus(n_tokens=30_000, vocab=vocab, seq_len=17, seed=0)
    ds = j_hetero({"seq": seqs, "y": topics}, "y", N, alpha=0.1, seed=0)
    it = j_batches(ds, 2, seed=0)
    out = []
    for _ in range(STEPS):
        s = next(it)["seq"]
        out.append({"tokens": s[..., :-1], "labels": s[..., 1:]})
    return out


def _mlp_setup():
    rng = np.random.default_rng(0)
    params = {"w1": (rng.normal(size=(12, 16)) * 0.3).astype(np.float32),
              "b1": np.zeros(16, np.float32),
              "w2": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32),
              "b2": np.zeros(4, np.float32)}
    batches = [{"x": rng.normal(size=(N, 8, 12)).astype(np.float32),
                "y": rng.integers(0, 4, size=(N, 8)).astype(np.int32)}
               for _ in range(STEPS)]
    return params, batches


def _t_mlp_loss(p, b):
    h = torch.relu(b["x"] @ p["w1"] + p["b1"])
    lp = torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1)
    return -torch.gather(lp, 1, b["y"][:, None].long()).mean(), {}


def _smollm():
    jcfg = j_reduced("smollm-360m")
    jmodel = j_build(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0)))
    return jcfg, jmodel, params, _lm_batches(jcfg.vocab_size)


def _perms(n_steps: int) -> list:
    """The reference step's bucket permutation of each step (it splits its
    key and draws from the first half)."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.permutation(jax.random.split(sub)[0],
                                                   N)))
    return out


def _tcfg(trainer_kw: dict, spec_kw: dict, worker_axes) -> TCfg:
    kw = dict(trainer_kw)
    attack = kw.pop("attack", "alie")
    eta = 8.0 if attack == "alie" else None
    return TCfg(beta=0.9, agg=TSpec(f=F, **spec_kw),
                byz=TByz(f=F, attack=attack, eta=eta),
                worker_axes=worker_axes, **kw)


def _run_port(model: str, trainer_kw: dict, spec_kw: dict, worker_axes,
              payload: dict) -> dict:
    """STEPS steps of the port's step; returns the metrics and the final
    parameters (numpy)."""
    if model == "smollm":
        tmodel = t_build(t_reduced("smollm-360m"))
        loss_fn, lr = tmodel.loss, t_cosine(0.05, STEPS, warmup=0)
    else:
        loss_fn, lr = _t_mlp_loss, t_constant(0.3)
    cfg = _tcfg(trainer_kw, spec_kw, worker_axes)
    opt = t_sgd(clip=2.0)
    calls = [0]

    def counted(params, batch):
        calls[0] += 1
        return loss_fn(params, batch)

    step = t_build_step(counted, opt, cfg, lr)
    state = t_init_state(params_from_numpy(payload[model]["params"], CPU), opt,
                         N, cfg)
    rows = []
    for t, b in enumerate(payload[model]["batches"]):
        state, m = step(state, to_device(b, CPU),
                        perm=torch.from_numpy(payload["perms"][t]),
                        generator=torch.Generator().manual_seed(t))
        rows.append({k: np.asarray(v.detach() if torch.is_tensor(v) else v,
                                   np.float64) for k, v in m.items()})
    rec = kdispatch.last_dispatch()
    return {"rows": rows, "params": params_to_numpy(state["params"]),
            "calls": calls[0], "mesh_devices": rec.mesh_devices,
            "backend": rec.backend}


def _world(rank: int, world: int, payload: dict) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh((world,), ("shard",))
    out = {}
    with tmesh.use_mesh(mesh):
        for tag, model, trainer_kw, spec_kw, _ in CASES:
            out[tag] = _run_port(model, trainer_kw, spec_kw, ("shard",),
                                 payload)
    return out


def _payload() -> dict:
    _, _, sparams, sbatches = _smollm()
    mparams, mbatches = _mlp_setup()
    return {"smollm": {"params": sparams, "batches": sbatches},
            "mlp": {"params": mparams, "batches": mbatches},
            "perms": _perms(STEPS)}


@pytest.fixture(scope="module")
def runs():
    payload = _payload()
    ranks = tmesh.spawn_world(_world, 2, (payload,), limit=WORLD_LIMIT)
    return payload, ranks


def _reference(spec_kw: dict, payload: dict) -> dict:
    """The reference's jitted single-device smollm steps."""
    _, jmodel, params, batches = _smollm()
    kw = {k: v for k, v in spec_kw.items() if k != "backend"}
    jcfg = JCfg(algorithm="dshb", beta=0.9,
                agg=JSpec(f=F, backend="xla", **kw),
                byz=JByz(f=F, attack="alie", eta=8.0))
    opt = j_sgd(clip=2.0)
    jstep = jax.jit(j_build_step(jmodel.loss, opt, jcfg,
                                 j_cosine(0.05, STEPS, warmup=0)))
    state = j_init_state(jax.tree_util.tree_map(jnp.asarray, params), opt, N,
                         jcfg)
    key = jax.random.PRNGKey(0)
    rows = []
    for b in batches:
        key, sub = jax.random.split(key)
        state, m = jstep(state, b, sub)
        rows.append({k: float(m[k]) for k in ("loss", "kappa_hat",
                                              "direction_norm", "lr")})
    return {"rows": rows,
            "params": jax.tree_util.tree_map(np.asarray, state["params"])}


def _leaves(tree) -> list:
    return jax.tree_util.tree_leaves(tree)


def _check(got: dict, want: dict, tag: str) -> None:
    for t, (g, w) in enumerate(zip(got["rows"], want["rows"])):
        assert float(g["loss"]) == pytest.approx(float(w["loss"]),
                                                 rel=1e-5), (tag, t)
        assert float(g["direction_norm"]) == pytest.approx(
            float(w["direction_norm"]), rel=1e-4), (tag, t)
        assert float(g["kappa_hat"]) == pytest.approx(
            float(w["kappa_hat"]), rel=1e-4, abs=1e-4), (tag, t)
    gp, wp = _leaves(got["params"]), _leaves(want["params"])
    assert len(gp) == len(wp)
    scale = max(float(np.abs(b).max()) for b in wp)
    for a, b in zip(gp, wp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                   err_msg=tag)


def test_rank_copies_stay_equal(runs):
    """Equal parameters and metrics on both ranks; each rank ran the
    sharded backend over both ranks and computed the gradients of half
    the workers, each once."""
    _, ranks = runs
    for tag, _, _, spec_kw, _ in CASES:
        for r in ranks:
            assert r[tag]["calls"] == STEPS * N // 2, tag
            assert r[tag]["mesh_devices"] == 2, tag
            assert r[tag]["backend"] == spec_kw["backend"], tag
        for a, b in zip(_leaves(ranks[0][tag]["params"]),
                        _leaves(ranks[1][tag]["params"])):
            np.testing.assert_array_equal(a, b, err_msg=tag)
        for ra, rb in zip(ranks[0][tag]["rows"], ranks[1][tag]["rows"]):
            for k in ra:
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=tag)


@pytest.mark.parametrize("case", [c for c in CASES if c[4]],
                         ids=lambda c: c[0])
def test_smollm_matches_reference_step(runs, case):
    tag, _, _, spec_kw, _ = case
    payload, ranks = runs
    _check(ranks[0][tag], _reference(spec_kw, payload), tag)


@pytest.mark.parametrize("case", [c for c in CASES if not c[4]],
                         ids=lambda c: c[0])
def test_mlp_matches_single_process_port(runs, case):
    tag, model, trainer_kw, spec_kw, _ = case
    payload, ranks = runs
    solo = dict(spec_kw, backend="cuda")
    if spec_kw["backend"] == "cuda_hier":
        solo["hier"] = True
    want = _run_port(model, trainer_kw, solo, None, payload)
    got = ranks[0][tag]
    _check(got, want, tag)
    for g, w in zip(got["rows"], want["rows"]):
        for k in w:
            if k.startswith("taps."):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{tag} {k}")
    if trainer_kw.get("taps"):
        assert any(k.startswith("taps.trim_frac") for k in got["rows"][0])


def test_worker_axes_refusals():
    """Without a mesh, with axes the mesh lacks or a single-device
    backend, the sharded step refuses (in a world: below)."""
    params = params_from_numpy(_mlp_setup()[0], CPU)
    cfg = _tcfg({}, dict(rule="cwtm", pre="nnm", backend="cuda_sharded"),
                ("shard",))
    with pytest.raises(ValueError, match="multi-rank mesh"):
        t_init_state(params, t_sgd(), N, cfg)


def _refusals(rank: int, world: int) -> list:
    torch.set_num_threads(1)
    params = params_from_numpy(_mlp_setup()[0], CPU)
    out = []
    with tmesh.use_mesh(tmesh.make_mesh((world,), ("shard",))):
        for spec_kw, axes, trainer_kw in (
                (dict(backend="cuda_sharded"), ("data",), {}),
                (dict(backend="cuda"), ("shard",), {}),
                (dict(backend="cuda_sharded"), ("shard",),
                 dict(fsdp_keys=("w1",)))):
            cfg = dataclasses.replace(
                _tcfg(trainer_kw, dict(rule="cwtm", pre="nnm", **spec_kw),
                      axes))
            try:
                t_init_state(params, t_sgd(), N, cfg)
                out.append("ran")
            except ValueError as e:
                out.append(str(e))
    return out


def test_worker_axes_refusals_in_a_world():
    """The axes and the backend are refused; fsdp_keys under worker_axes
    runs (its parity is the mlp/fsdp case above)."""
    got = tmesh.spawn_world(_refusals, 2, limit=120)[0]
    assert "not axes of the mesh" in got[0]
    assert "'cuda_sharded' or 'cuda_hier'" in got[1]
    assert got[2] == "ran"
