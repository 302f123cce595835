"""The port's attention-free and encoder-decoder families (rwkv6-3b,
zamba2-2.7b, whisper-base) against the reference, on the CPU.

Both packages run the reduced configs (fp32) from the same parameters:
the reference's init carried across with ``repro_torch.interop``, with
every constant-initialised leaf (lerp coefficients, decay bias, u,
a_log, dt_bias, d_skip, norm gains and biases, conv and MLP biases)
moved off its constant first, so a swapped index or a dropped bias
shows.  Inputs are drawn from numpy seeds.

Tolerance: 1e-5 of the largest magnitude (of the whole array; a scalar
is its own magnitude), as the attention family's tests.  Both packages
sum fp32 products in another order, and the chunked scan's cumulative
log-decay is summed in another order too (``jnp.cumsum`` against
``torch.cumsum``): an fp32 cumsum over a chunk of Q steps of |w| <=
MAX_STEP_DECAY = 1 is off by at most about Q * eps * Q, i.e. 1.5e-5 in
the exponent at Q = 16, and that relative error carries through
``exp(cum)`` into each pair's weight.  The factorised pair weights
e^{c_i} e^{-c_j} are at most 1, so the error is relative to the
output's magnitude.  Observed on the CPU: the scans within 4.3e-7 of
their largest magnitude, whole-model gradients and one step within
2.4e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.types import AggregatorSpec as JSpec
from repro.models import attention as j_attn
from repro.models import build_model as j_build
from repro.models import common as j_common
from repro.models import linear_scan as j_ls
from repro.models import mlp as j_mlp
from repro.models import rwkv as j_rwkv
from repro.models import ssm as j_ssm
from repro.models.common import ParamDesc as JDesc
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_constant
from repro.training import ByzantineConfig as JByz
from repro.training import TrainerConfig as JCfg
from repro.training import build_train_step as j_build_step
from repro.training import init_state as j_init_state
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.interop import params_from_numpy, params_to_numpy, state_to_numpy
from repro_torch.launch.train import lm_batch
from repro_torch.models import EncDecLM
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model as t_build
from repro_torch.models import common as t_common
from repro_torch.models import linear_scan as t_ls
from repro_torch.models import mlp as t_mlp
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import ssm as t_ssm
from repro_torch.optim import sgd as t_sgd
from repro_torch.optim.schedules import constant as t_constant
from repro_torch.training import ByzantineConfig as TByz
from repro_torch.training import TrainerConfig as TCfg
from repro_torch.training import build_train_step as t_build_step
from repro_torch.training import init_state as t_init_state
from repro_torch.training.trainer import to_device
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(2)
CPU = torch.device("cpu")
TOL = 1e-5
FAMILY_ARCHS = ("rwkv6-3b", "zamba2-2.7b", "whisper-base")
B, S = 2, 32


def _close(got, want, what: str, scale=None) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# The chunked scan.
# ---------------------------------------------------------------------------

def _scan_inputs(seed: int, *, u: bool, init: bool, extreme: bool,
                 b=2, s=64, h=3, k=8, v=5):
    rng = np.random.default_rng(seed)
    q, kk = (rng.standard_normal((b, s, h, k)).astype(np.float32)
             for _ in range(2))
    vv = rng.standard_normal((b, s, h, v)).astype(np.float32)
    if extreme:        # every step at the models' clamp
        w = np.full((b, s, h, k), -t_ls.MAX_STEP_DECAY, np.float32)
    else:
        w = -rng.uniform(1e-6, t_ls.MAX_STEP_DECAY,
                         (b, s, h, k)).astype(np.float32)
    uu = rng.standard_normal((h, k)).astype(np.float32) if u else None
    st = rng.standard_normal((b, h, k, v)).astype(np.float32) if init else None
    return q, kk, vv, w, uu, st


@pytest.mark.parametrize("extreme", [False, True], ids=["random", "max-decay"])
@pytest.mark.parametrize("init", [False, True], ids=["zero-state", "init-state"])
@pytest.mark.parametrize("u", [False, True], ids=["mamba2", "rwkv6"])
def test_gla_chunked_matches_reference(u, init, extreme):
    """Chunk 16, seq 64 (four chunks): the port's chunked scan against the
    reference's chunked scan and token-by-token oracle, y and the final
    state; the port's oracle against the reference's too."""
    q, k, v, w, uu, st = _scan_inputs(7, u=u, init=init, extreme=extreme)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(w))
    jkw = dict(u=None if uu is None else jnp.asarray(uu),
               init_state=None if st is None else jnp.asarray(st))
    tkw = dict(u=None if uu is None else _t(uu),
               init_state=None if st is None else _t(st))
    targs = (_t(q), _t(k), _t(v), _t(w))
    jy, js = j_ls.gla_chunked(*jargs, chunk=16, **jkw)
    ny, ns = j_ls.gla_naive(*jargs, **jkw)
    ty, ts = t_ls.gla_chunked(*targs, chunk=16, **tkw)
    oy, os_ = t_ls.gla_naive(*targs, **tkw)
    assert ty.dtype == ts.dtype == torch.float32
    for want, what in ((jy, "chunked"), (ny, "naive")):
        _close(ty, want, f"y vs reference {what}")
    for want, what in ((js, "chunked"), (ns, "naive")):
        _close(ts, want, f"state vs reference {what}")
    _close(oy, ny, "port naive y")
    _close(os_, ns, "port naive state")


def test_gla_chunked_needs_whole_chunks():
    q, k, v, w, _, _ = _scan_inputs(0, u=False, init=False, extreme=False,
                                    s=24)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_ls.gla_chunked(_t(q), _t(k), _t(v), _t(w), chunk=16)


def test_gla_decode_step_matches_reference():
    q, k, v, w, uu, st = _scan_inputs(3, u=True, init=True, extreme=False)
    for u in (None, uu):
        jy, js = j_ls.gla_decode_step(jnp.asarray(st), q[:, 0], k[:, 0],
                                      v[:, 0], w[:, 0], u)
        ty, ts = t_ls.gla_decode_step(_t(st), _t(q[:, 0]), _t(k[:, 0]),
                                      _t(v[:, 0]), _t(w[:, 0]),
                                      None if u is None else _t(u))
        _close(ty, jy, "y")
        _close(ts, js, "state")


# ---------------------------------------------------------------------------
# Layer math and blocks.
# ---------------------------------------------------------------------------

def _desc_leaves(tree) -> list:
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JDesc))


def _setup(arch: str, seed: int = 0, **replace):
    """Both models of a reduced config and the reference's init as numpy,
    every constant-initialised leaf moved off its constant."""
    jcfg = j_reduced(arch)
    tcfg = t_reduced(arch)
    if replace:
        jcfg, tcfg = jcfg.replace(**replace), tcfg.replace(**replace)
    jmodel, tmodel = j_build(jcfg), t_build(tcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out = []
    for a, d in zip(leaves, _desc_leaves(jmodel.param_descs())):
        if d.init in ("ones", "zeros"):
            a = (a + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return jcfg, jmodel, tmodel, jax.tree_util.tree_unflatten(treedef, out)


def _x(cfg, seed: int = 1, s: int = S) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _layer0(tree) -> dict:
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((B, S, 48))).astype(np.float32)
    g, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    _close(t_common.layer_norm(_t(x), _t(g), _t(b)),
           j_common.layer_norm(jnp.asarray(x), g, b), "layer_norm")
    # bf16 in, bf16 out, fp32 inside: the fp32 results differ in their
    # summation order only, so a rounding to bf16 may land one ulp
    # (2^-7 of the value's binade) apart, no more.
    xb = torch.from_numpy(x).bfloat16()
    got = t_common.layer_norm(xb, _t(g), _t(b))
    want = np.asarray(j_common.layer_norm(jnp.asarray(x, jnp.bfloat16), g, b),
                      np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want)).all(), float(err.max())
    assert (err == 0).mean() > 0.99


@pytest.mark.parametrize("seq,dim", [(32, 128), (1500, 512), (7, 10)])
def test_sinusoidal_positions_match_reference(seq, dim):
    got = t_common.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and got.shape == (seq, dim)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_common.sinusoidal_positions(seq, dim)))


def test_gelu_mlp_matches_reference():
    _, _, _, params = _setup("whisper-base")
    p = _layer0(params["encoder"]["mlp"])
    x = _x(j_reduced("whisper-base"))
    _close(t_mlp.gelu_mlp(params_from_numpy(p), _t(x)),
           j_mlp.gelu_mlp(p, jnp.asarray(x)), "gelu_mlp")


def test_time_and_channel_mix_match_reference():
    cfg, _, _, params = _setup("rwkv6-3b")
    p = _layer0(params["blocks"]["rwkv"])
    tp = params_from_numpy(p)
    x = _x(cfg)
    tcfg = t_reduced("rwkv6-3b")
    _close(t_rwkv.time_mix(tp, _t(x), tcfg),
           j_rwkv.time_mix(p, jnp.asarray(x), cfg), "time_mix")
    _close(t_rwkv.channel_mix(tp, _t(x), tcfg),
           j_rwkv.channel_mix(p, jnp.asarray(x), cfg), "channel_mix")
    # The decay stays inside the scan's clamp.
    w = t_rwkv._log_decay(tp, _t(x))
    assert float(w.min()) >= -t_ls.MAX_STEP_DECAY and float(w.max()) < 0


def test_ssm_block_matches_reference():
    cfg, _, _, params = _setup("zamba2-2.7b")
    p = _layer0(params["blocks"]["ssm"])
    x = _x(cfg)
    _close(t_ssm.ssm_block(params_from_numpy(p), _t(x), t_reduced("zamba2-2.7b")),
           j_ssm.ssm_block(p, jnp.asarray(x), cfg), "ssm_block")
    # The split and the short conv, piece by piece.
    tp = params_from_numpy(p)
    for got, want in zip(t_ssm._project(tp, _t(x), t_reduced("zamba2-2.7b")),
                         j_ssm._project(p, jnp.asarray(x), cfg)):
        _close(got, want, "_project")
    c = x[..., :cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state]
    _close(t_ssm._short_conv(_t(c), tp["conv_w"], tp["conv_b"]),
           j_ssm._short_conv(jnp.asarray(c), p["conv_w"], p["conv_b"]),
           "_short_conv")


@pytest.mark.parametrize("mode", ["non-causal", "causal-no-rope", "cross"])
def test_attention_modes_match_reference(mode):
    cfg, _, _, params = _setup("whisper-base")
    tcfg = t_reduced("whisper-base")
    key = "cross_attn" if mode == "cross" else "self_attn"
    p = _layer0(params["decoder"][key])
    x = _x(cfg)
    kw = {"non-causal": dict(causal=False, use_rope=False),
          "causal-no-rope": dict(causal=True, use_rope=False)}.get(mode, {})
    jkw, tkw = dict(kw), dict(kw)
    if mode == "cross":
        rng = np.random.default_rng(5)
        kv = [rng.standard_normal((B, 48, cfg.num_kv_heads, cfg.head_dim)
                                  ).astype(np.float32) for _ in range(2)]
        jkw["kv_override"] = tuple(jnp.asarray(a) for a in kv)
        tkw["kv_override"] = tuple(_t(a) for a in kv)
    got = t_attn.attention(params_from_numpy(p), _t(x), tcfg, **tkw)
    _close(got, j_attn.attention(p, jnp.asarray(x), cfg, **jkw), mode)
    if mode == "non-causal":
        # The first position sees the last one.
        x2 = x.copy()
        x2[:, -1] += 1.0
        got2 = t_attn.attention(params_from_numpy(p), _t(x2), tcfg, **tkw)
        assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# Whole models: forward, loss, every gradient, one D-SHB step.
# ---------------------------------------------------------------------------

def _batch(cfg, seed: int = 0, lead=(B,), s: int = S) -> dict:
    """Tokens / labels (three masked positions); an encoder-decoder's
    frames are seeded normal (the CLI's zeros would hide the encoder)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, lead + (s,)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, lead + (s,)).astype(np.int32)
    labels[..., :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            lead + (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _t_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    cfg, jmodel, tmodel, params = _setup(arch)
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        params, batch)
    tparams = params_from_numpy(params, CPU)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tl, tm = tmodel.loss(tparams, _t_batch(batch))
    tg = torch.autograd.grad(tl, leaves)
    with torch.no_grad():
        logits = tmodel.forward(tparams, _t_batch(batch))
    _close(logits, jax.jit(jmodel.forward)(params, batch), "forward")
    _close(tl.detach(), jl, "loss")
    _close(tm["ce"].detach(), jm["ce"], "ce")
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert tree_paths(tparams) == [jax.tree_util.keystr(p) for p, _ in flat]
    for path, g, (_, want) in zip(tree_paths(tparams), tg, flat):
        assert float(np.abs(np.asarray(want)).max()) > 0, path
        _close(g, want, f"grad {path}")


def _configs():
    kw = dict(algorithm="dshb", beta=0.9)
    return (JCfg(agg=JSpec(rule="cwtm", f=1, pre="nnm", backend="xla"),
                 byz=JByz(f=1, attack="alie"), **kw),
            TCfg(agg=TSpec(rule="cwtm", f=1, pre="nnm"),
                 byz=TByz(f=1, attack="alie"), **kw))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dshb_step_matches_reference(arch):
    """One D-SHB step, n = 4, f = 1, ALIE, NNM + CWTM, every leaf robust:
    params, momentum and metrics against the reference's jitted step;
    every leaf moved (the fp32 a_log / dt_bias / d_skip / decay_bias / u
    beside the model's leaves in the one flat stack)."""
    n = 4
    cfg, jmodel, tmodel, params = _setup(arch)
    batch = _batch(cfg, lead=(n, B))
    jtc, ttc = _configs()
    jopt, topt = j_sgd(clip=2.0), t_sgd(clip=2.0)
    jstep = jax.jit(j_build_step(jmodel.loss, jopt, jtc, j_constant(0.05)))
    tstep = t_build_step(tmodel.loss, topt, ttc, t_constant(0.05))
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, params), jopt,
                          n, jtc)
    tstate = t_init_state(params_from_numpy(params, CPU), topt, n, ttc)
    jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, to_device(batch, CPU))
    for k in ("loss", "direction_norm", "kappa_hat", "lr"):
        _close(float(tm[k]), float(jm[k]), k)
    jp = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate["params"])]
    tp = tree_leaves(params_to_numpy(tstate["params"]))
    scale = max(float(np.abs(a).max()) for a in jp)
    for i, (a, b) in enumerate(zip(tp, jp)):
        _close(a, b, f"params[{i}]", scale)
    for a, b in zip(tp, jax.tree_util.tree_leaves(params)):
        assert np.abs(a - np.asarray(b)).max() > 0
    jmom = [np.asarray(m) for m in jstate["momentum"]]
    tmom = state_to_numpy(tstate)["momentum"]
    scale = max(float(np.abs(a).max()) for a in jmom)
    for i, (a, b) in enumerate(zip(tmom, jmom)):
        _close(a, b, f"momentum[{i}]", scale)


def test_hybrid_depth_must_be_a_multiple_of_attn_every():
    cfg = t_reduced("zamba2-2.7b").replace(num_layers=5, attn_every=2)
    with pytest.raises(ValueError, match="attn_every"):
        t_build(cfg)
    with pytest.raises(AssertionError):
        j_build(j_reduced("zamba2-2.7b").replace(num_layers=5,
                                                 attn_every=2)).param_descs()


def test_hybrid_shared_block_runs_once_a_group():
    """attn_every = 2 over 4 layers: the shared block runs twice, and its
    gradient is the sum over both groups (the reference's too)."""
    arch = "zamba2-2.7b"
    cfg, jmodel, tmodel, params = _setup(arch, num_layers=4, attn_every=2)
    batch = _batch(cfg)
    jg = jax.jit(jax.grad(lambda p: jmodel.loss(p, batch)[0]))(params)
    tparams = params_from_numpy(params, CPU)
    calls = []
    shared_block = tmodel._shared_block
    tmodel._shared_block = lambda h, s: calls.append(1) or shared_block(h, s)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams["shared"])]
    loss, _ = tmodel.loss(tparams, _t_batch(batch))
    tg = torch.autograd.grad(loss, leaves)
    assert len(calls) == 2
    want = jax.tree_util.tree_leaves(jg["shared"])
    for path, g, w in zip(tree_paths(tparams["shared"]), tg, want):
        _close(g, w, f"shared grad {path}")


def test_lm_batch_adds_zero_frames_for_encdec():
    cfg = t_reduced("whisper-base")
    seq = np.random.default_rng(0).integers(0, 100, (3, 2, 17))
    batch = lm_batch(seq, cfg, 16)
    assert batch["frames"].shape == (3, 2, cfg.encoder_seq, cfg.d_model)
    assert batch["frames"].dtype == np.float32 and not batch["frames"].any()
    assert batch["tokens"].shape == batch["labels"].shape == (3, 2, 16)
    assert "frames" not in lm_batch(seq, t_reduced("rwkv6-3b"), 16)


def test_encdec_decode_matches_reference():
    """Whisper's cached decode from ``prefill_cache`` on seeded frames: 12
    steps, the logits and the self k / v at every step, and the cross k /
    v (read, never written) against the reference's."""
    cfg, jmodel, tmodel, params = _setup("whisper-base")
    assert isinstance(tmodel, EncDecLM)
    tparams = params_from_numpy(params, CPU)
    frames = _batch(cfg)["frames"]
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 12)).astype(np.int32)
    jc = jmodel.prefill_cache(params, jnp.asarray(frames), B, 12)
    tc = tmodel.prefill_cache(tparams, torch.from_numpy(frames), B, 12)
    cross = tc["cross_k"].clone()
    step = jax.jit(jmodel.decode_step)
    for t in range(12):
        jl, jc = step(params, jc, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        tl, tc = tmodel.decode_step(tparams, tc,
                                    torch.from_numpy(tokens[:, t:t + 1]), t)
        _close(tl, jl, f"step {t} logits")
        for key in ("cross_k", "cross_v", "k", "v"):
            _close(tc[key], jc[key], f"step {t} {key}")
    assert torch.equal(tc["cross_k"], cross)
