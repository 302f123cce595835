"""The port's cached decode and ServeEngine against the reference, on the
CPU.

Both packages run the reduced configs (fp32) from the same parameters:
the reference's init carried across with ``repro_torch.interop``, every
constant-initialised leaf moved off its constant first (as in
``test_torch_families.py``), so a swapped index or a dropped bias shows.
Tokens and frames are drawn from numpy seeds.

Tolerance: 1e-5 of the largest magnitude of the whole array (logits or
cache leaf), as the families' tests.  Both packages sum fp32 products in
other orders; the decode recurrences (the RWKV / Mamba2 state, the conv
window) carry that rounding from step to step, but each step adds one
rounding of the state's own size, so 16 steps stay far inside it.

The port writes caches in place, so a test that starts two paths from one
cache clones it first.  The reference's forward and decode differ where a
MoE forward drops tokens past its capacity; decode-vs-forward tests raise
``capacity_factor`` to 8.0 for MoE, as the reference's own test does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.launch import roofline as j_roof
from repro.models import attention as j_attn
from repro.models import build_model as j_build
from repro.models.common import ParamDesc as JDesc
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.interop import (
    cache_from_numpy, cache_to_numpy, params_from_numpy,
)
from repro_torch.launch import roofline as t_roof
from repro_torch.launch import serve
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model as t_build
from repro_torch.models.common import apply_rope
from repro_torch.serving import ServeEngine, greedy_decode
from repro_torch.tree import tree_leaves, tree_map, tree_paths

torch.set_num_threads(2)
CPU = torch.device("cpu")
TOL = 1e-5
B = 2


def _close(got, want, what: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)
    return err


def _desc_leaves(tree) -> list:
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JDesc))


def _setup(arch: str, seed: int = 0, **replace):
    """Both models of a reduced config and the reference's init as numpy,
    every constant-initialised leaf moved off its constant."""
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
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
    return jcfg, tcfg, jmodel, tmodel, jax.tree_util.tree_unflatten(treedef, out)


def _frames(cfg, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                               ).astype(np.float32)


def _caches(cfg, jmodel, tmodel, params, tparams, max_seq: int):
    """The reference's and the port's starting caches (an
    encoder-decoder's from ``prefill_cache`` on the same frames)."""
    if cfg.family == "encdec":
        frames = _frames(cfg)
        jc = jmodel.prefill_cache(params, jnp.asarray(frames), B, max_seq)
        tc = tmodel.prefill_cache(tparams, torch.from_numpy(frames), B,
                                  max_seq)
    else:
        jc = jmodel.init_cache(B, max_seq)
        tc = tmodel.init_cache(B, max_seq, CPU)
    return jc, tc


def _clone(cache):
    return tree_map(lambda t: t.clone(), cache)


def _cache_close(tcache, jcache, what: str) -> None:
    flat, _ = jax.tree_util.tree_flatten_with_path(jcache)
    assert tree_paths(tcache) == [jax.tree_util.keystr(p) for p, _ in flat]
    for path, got, (_, want) in zip(tree_paths(tcache), tree_leaves(tcache),
                                    flat):
        assert str(got.dtype) == f"torch.{want.dtype}", (what, path)
        _close(got, want, f"{what} cache {path}")


# ---------------------------------------------------------------------------
# Decode step by step against the reference, every arch.
# ---------------------------------------------------------------------------

def _steps(arch: str) -> tuple[int, int]:
    """(steps, max_seq): mixtral's window of 32 wraps (48 steps over a
    span of 32 slots); every other arch 16 steps into a 16-slot cache."""
    return (48, 64) if arch == "mixtral-8x22b" else (16, 16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_reference_step_by_step(arch):
    cfg, tcfg, jmodel, tmodel, params = _setup(arch)
    tparams = params_from_numpy(params, CPU)
    steps, max_seq = _steps(arch)
    if arch == "mixtral-8x22b":
        assert cfg.sliding_window == 32 and t_attn.cache_span(
            tcfg, max_seq) == 32
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int32)
    jc, tc = _caches(cfg, jmodel, tmodel, params, tparams, max_seq)
    _cache_close(tc, jc, "start")
    step = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jl, jc = step(params, jc, jnp.asarray(tokens[:, t:t + 1]),
                      jnp.int32(t))
        tl, tc = tmodel.decode_step(tparams, tc,
                                    torch.from_numpy(tokens[:, t:t + 1]), t)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        _close(tl, jl, f"step {t} logits")
        _cache_close(tc, jc, f"step {t}")


def test_encdec_cache_layout_and_sinusoid():
    """Whisper's cache: the self pair (L, B, max_seq, hkv, hd) and the
    cross pair (L, B, encoder_seq, hkv, hd), zeros from ``init_cache``
    (the engine's start) and from ``prefill_cache`` the encoder's
    projections; ``_sinusoid_at`` against the reference's at several
    positions."""
    from repro.models.encdec import _sinusoid_at as j_sin
    from repro_torch.models.encdec import _sinusoid_at as t_sin
    cfg, tcfg, jmodel, tmodel, params = _setup("whisper-base")
    cache = tmodel.init_cache(B, 12, CPU)
    assert sorted(cache) == ["cross_k", "cross_v", "k", "v"]
    hd, hkv = tcfg.head_dim, tcfg.num_kv_heads
    assert cache["k"].shape == (tcfg.num_layers, B, 12, hkv, hd)
    assert cache["cross_k"].shape == (tcfg.num_layers, B, tcfg.encoder_seq,
                                      hkv, hd)
    assert not any(t.any() for t in tree_leaves(cache))
    want = jax.tree_util.tree_map(np.asarray, jmodel.init_cache(B, 12))
    _cache_close(cache, want, "init_cache")
    for pos in (0, 1, 7, 447, 32767):
        got = t_sin(pos, tcfg.d_model, CPU)
        assert got.dtype == torch.float32 and got.shape == (1, 1, tcfg.d_model)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(j_sin(jnp.int32(pos),
                                                    cfg.d_model)),
                                   rtol=0, atol=2e-6 * max(1, pos))


# ---------------------------------------------------------------------------
# The reference's own decode tests, ported.
# ---------------------------------------------------------------------------

def _forward_batch(tcfg, tokens: np.ndarray) -> dict:
    batch = {"tokens": torch.from_numpy(tokens)}
    if tcfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(tcfg))
    return batch


def _decode_all(tmodel, tparams, tokens: np.ndarray, cache) -> torch.Tensor:
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = tmodel.decode_step(
            tparams, cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def _text_model(tmodel, tparams):
    """A VLM's decode embeds text only: its forward counterpart is the
    same weights as a dense config without the projector."""
    if tmodel.cfg.family != "vlm":
        return tmodel, tparams
    dense = t_build(tmodel.cfg.replace(family="dense"))
    return dense, {k: v for k, v in tparams.items() if k != "projector"}


def _decode_and_forward(tcfg) -> tuple[torch.Tensor, torch.Tensor]:
    """16 cached decode steps and the full forward of the same 16 tokens
    (an encoder-decoder over the same frames), as (B, 16, V) logits."""
    tmodel = t_build(tcfg)
    tparams = tmodel.init(2, CPU)
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, 16)).astype(np.int32)
    fmodel, fparams = _text_model(tmodel, tparams)
    with torch.no_grad():
        full = fmodel.forward(fparams, _forward_batch(tcfg, tokens))
    if tcfg.family == "encdec":
        cache = tmodel.prefill_cache(tparams, torch.from_numpy(_frames(tcfg)),
                                     B, 16)
    else:
        cache = tmodel.init_cache(B, 16, CPU)
    return _decode_all(tmodel, tparams, tokens, cache), full


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b", "zamba2-2.7b",
                                  "whisper-base", "internvl2-2b"])
def test_decode_matches_forward(arch):
    """Decode against the full forward at the reference's rtol = atol =
    2e-3 (fp32, reduced config; the reference skips its VLM, which here is
    held against the text-only forward)."""
    dec, full = _decode_and_forward(t_reduced(arch))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


#: bf16 decode against the bf16 forward: the two run the same math on
#: other shapes ((B, 1, d) products against (B, S, d); a masked softmax
#: over the cache against one over the sequence), so each bf16 rounding
#: of an activation (relative 2^-9, 2^-8 at worst) may land one ulp
#: apart, and two layers' residual updates and the final norm carry such
#: differences into the logits, which are themselves a bf16 product.  The
#: logits of a random-init model are O(1); 1 / 32 of their largest
#: magnitude is four bf16 ulps of it.  The recurrent families carry the
#: roundings from step to step through their state, and zamba2's forward
#: rounds each Mamba2 conv output to bf16 where its decode keeps fp32
#: (the reference's arithmetic): 1 / 8 (zamba2 measured 2.1 %).
BF16_REL = 1.0 / 32
BF16_REL_RECURRENT = 1.0 / 8


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b", "zamba2-2.7b",
                                  "whisper-base", "internvl2-2b",
                                  "mixtral-8x22b"])
def test_decode_matches_forward_in_bf16(arch):
    tcfg = t_reduced(arch).replace(dtype=torch.bfloat16)
    if tcfg.num_experts:
        tcfg = tcfg.replace(capacity_factor=8.0)   # no forward drops
    dec, full = _decode_and_forward(tcfg)
    assert dec.dtype == torch.float32
    err = float((dec - full).abs().max())
    rel = BF16_REL_RECURRENT if tcfg.family in ("ssm", "hybrid") else BF16_REL
    assert err <= rel * float(full.abs().max()), (arch, err)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_runs(arch):
    """Shape, finite logits, the same tree back (the same dict and the
    same tensors: written in place)."""
    tcfg = t_reduced(arch)
    tmodel = t_build(tcfg)
    tparams = tmodel.init(3, CPU)
    if tcfg.family == "encdec":
        cache = tmodel.prefill_cache(tparams, torch.from_numpy(_frames(tcfg)),
                                     B, 8)
    else:
        cache = tmodel.init_cache(B, 8, CPU)
    before = [(p, t.shape, t.dtype, t.data_ptr())
              for p, t in zip(tree_paths(cache), tree_leaves(cache))]
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, 1)))
    logits, cache2 = tmodel.decode_step(tparams, cache, tok, 0)
    assert logits.shape[:2] == (B, 1)
    assert bool(torch.isfinite(logits).all()), arch
    assert cache2 is cache
    assert [(p, t.shape, t.dtype, t.data_ptr()) for p, t in
            zip(tree_paths(cache2), tree_leaves(cache2))] == before


def test_cache_is_updated_in_place():
    """A decode step writes its k / v (or states) into the caller's
    tensors: a clone taken before keeps the old values."""
    for arch in ("qwen2-7b", "rwkv6-3b", "zamba2-2.7b"):
        tmodel = t_build(t_reduced(arch))
        tparams = tmodel.init(0, CPU)
        cache = tmodel.init_cache(B, 8, CPU)
        old = _clone(cache)
        tok = torch.zeros((B, 1), dtype=torch.long)
        _, new = tmodel.decode_step(tparams, cache, tok, 0)
        assert new is cache
        changed = [not torch.equal(a, b) for a, b in
                   zip(tree_leaves(new), tree_leaves(old))]
        assert all(changed), (arch, changed)
        assert not any(t.any() for t in tree_leaves(old))


# ---------------------------------------------------------------------------
# Prefill and generate.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x22b",
                                  "internvl2-2b", "rwkv6-3b", "zamba2-2.7b",
                                  "whisper-base"])
def test_prefill_matches_prefill_loop_and_reference(arch):
    """``prefill`` equals ``prefill_loop`` bit for bit (logits and cache,
    each from its own clone of one cache), and the reference's scanned
    prefill within TOL, for every family."""
    cfg, tcfg, jmodel, tmodel, params = _setup(arch, 4)
    tparams = params_from_numpy(params, CPU)
    P = 7
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    eng = ServeEngine(tmodel, tparams, batch_size=B, max_seq=16)
    jeng = JEngine(jmodel, params, batch_size=B, max_seq=16)
    jc0, tc0 = _caches(cfg, jmodel, tmodel, params, tparams, 16)
    cache_l, logits_l, p_l = eng.prefill_loop(_clone(tc0), prompts)
    cache_s, logits_s, p_s = eng.prefill(_clone(tc0), prompts)
    assert p_l == p_s == P
    assert torch.equal(logits_l, logits_s)
    for a, b in zip(tree_leaves(cache_l), tree_leaves(cache_s)):
        assert torch.equal(a, b)
    jcache, jlogits, jp = jeng.prefill(jc0, jnp.asarray(prompts))
    assert jp == P
    _close(logits_s, jlogits, "prefill logits")
    _cache_close(cache_s, jcache, "prefill")


def test_prefill_emits_its_span():
    from repro_torch.obs import runtime as obs_runtime
    tmodel = t_build(t_reduced("smollm-360m"))
    eng = ServeEngine(tmodel, tmodel.init(0, CPU), batch_size=B, max_seq=8)
    obs_runtime.reset()
    prompts = np.zeros((B, 3), np.int32)
    eng.prefill(eng.init_cache(), prompts)
    spans = obs_runtime.history(name="serve.prefill", kind="span")
    assert len(spans) == 1 and spans[0]["args"] == {"batch": B, "prompt": 3}
    assert eng.prefill(eng.init_cache(), prompts[:, :0])[1:] == (None, 0)


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-3b", "zamba2-2.7b"])
def test_generate_matches_reference_tokens(arch):
    """The port's generate against the reference's tokens.  Each step is
    teacher-forced on the reference's emitted tokens: the port's logits
    are held within TOL at every step, and its argmax must equal the
    reference's token at every step whose reference top-2 gap exceeds
    twice that tolerance (a near-tie may break either way; the count of
    such steps is asserted small and printed).  Where no step is a
    near-tie the port's own generate must reproduce the tokens."""
    cfg, tcfg, jmodel, tmodel, params = _setup(arch)
    tparams = params_from_numpy(params, CPU)
    P, N = 5, 12
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    jeng = JEngine(jmodel, params, batch_size=B, max_seq=P + N)
    want = jeng.generate(jnp.asarray(prompts), max_new=N)
    eng = ServeEngine(tmodel, tparams, batch_size=B, max_seq=P + N)

    # Teacher-forced: the reference's logits at each step beside the port's.
    jc = jeng.init_cache()
    jc, jl, _ = jeng.prefill(jc, jnp.asarray(prompts))
    tc, tl, _ = eng.prefill(eng.init_cache(), prompts)
    jsteps, tsteps = [np.asarray(jl[:, -1])], [tl[:, -1].numpy()]
    for i in range(N - 1):
        tok = want[:, i:i + 1]
        jl, jc = jax.jit(jmodel.decode_step)(params, jc, jnp.asarray(tok),
                                             jnp.int32(P + i))
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), P + i)
        jsteps.append(np.asarray(jl[:, -1]))
        tsteps.append(tl[:, -1].numpy())
    jlog, tlog = np.stack(jsteps, 1), np.stack(tsteps, 1)     # (B, N, V)
    _close(tlog, jlog, "teacher-forced logits")
    tol = TOL * float(np.abs(jlog).max())
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol            # (B, N)
    assert (np.argmax(tlog, -1) == want)[clear].all()
    ties = int((~clear).any(axis=0).sum())
    print(f"{arch}: {ties} of {N} steps excluded as near-ties")
    assert ties <= 2
    got = eng.generate(prompts, max_new=N)
    assert got.dtype == np.int32 and got.shape == (B, N)
    if ties == 0:
        np.testing.assert_array_equal(got, want)
    # The clocked generate changes nothing, and keeps each step's logits.
    clocked = serve.clocked_generate(eng, prompts, N, keep_logits=True)
    np.testing.assert_array_equal(clocked["tokens"], got)
    assert len(clocked["step_ms"]) == N - 1 and clocked["prefill_ms"] > 0
    assert "decode_step" not in vars(tmodel) and "prefill" not in vars(eng)
    np.testing.assert_array_equal(clocked["logits"].argmax(-1).numpy(), got)


def test_serve_engine_greedy_batch_and_determinism():
    """The reference's test_serve_engine_greedy_batch / _ssm, and
    greedy_decode against the engine."""
    tcfg = t_reduced("smollm-360m")
    tmodel = t_build(tcfg)
    tparams = tmodel.init(0, CPU)
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (3, 5))
    eng = ServeEngine(tmodel, tparams, batch_size=3, max_seq=40)
    out = eng.generate(prompts, max_new=8)
    assert out.shape == (3, 8) and (out >= 0).all()
    np.testing.assert_array_equal(out, eng.generate(prompts, max_new=8))
    np.testing.assert_array_equal(
        greedy_decode(tmodel, tparams, prompts, max_new=8, max_seq=40), out)
    np.testing.assert_array_equal(
        greedy_decode(tmodel, tparams, torch.from_numpy(prompts), max_new=8),
        out)
    rcfg = t_reduced("rwkv6-3b")
    rmodel = t_build(rcfg)
    reng = ServeEngine(rmodel, rmodel.init(0, CPU), batch_size=2, max_seq=16)
    assert reng.generate(np.zeros((2, 4), np.int64), max_new=4).shape == (2, 4)


def test_generate_keeps_padded_vocab_ids():
    """The head runs over pad_to(V, 128) columns; an argmax there is kept
    and embedded from the padded table, as the reference does (no mask)."""
    tcfg = t_reduced("qwen2-7b").replace(vocab_size=300)   # 384 columns
    tmodel = t_build(tcfg)
    tparams = tmodel.init(0, CPU)
    head = tparams["lm_head"]
    head[:, 300:] = 0.0
    head[:, 383] = 50.0 * head[:, :300].abs().max()     # dominate every row
    eng = ServeEngine(tmodel, tparams, batch_size=B, max_seq=8)
    out = eng.generate(np.zeros((B, 2), np.int64), max_new=3)
    assert (out == 383).any()


# ---------------------------------------------------------------------------
# The port's own behaviour.
# ---------------------------------------------------------------------------

def test_grouped_gqa_matches_repeated_form():
    """decode_attention's grouped contraction (q as (B, 1, hkv, g, hd)
    against the shared kv heads) against the repeated-kv form, and against
    the reference's grouped form (its default gqa_einsum=True)."""
    cfg, tcfg, _, _, params = _setup("qwen2-7b")
    assert tcfg.num_heads // tcfg.num_kv_heads == 2
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["attn"])
    tp = params_from_numpy(p)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    span, hkv, hd, hq = 12, tcfg.num_kv_heads, tcfg.head_dim, tcfg.num_heads
    ck = rng.standard_normal((B, span, hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((B, span, hkv, hd)).astype(np.float32)
    pos = 7
    out, k2, v2 = t_attn.decode_attention(
        tp, torch.from_numpy(x), torch.from_numpy(ck.copy()),
        torch.from_numpy(cv.copy()), pos, tcfg)
    # The repeated form, written out.
    xt = torch.from_numpy(x)
    q = (xt @ tp["wq"] + tp["bq"]).reshape(B, 1, hq, hd)
    q = apply_rope(q, torch.full((1, 1), pos), tcfg.rope_theta)
    kr = torch.repeat_interleave(k2, hq // hkv, dim=-2)
    vr = torch.repeat_interleave(v2, hq // hkv, dim=-2)
    lg = torch.einsum("bqhd,bkhd->bhqk", q, kr) * hd ** -0.5
    lg[..., pos + 1:] = t_attn.NEG_INF
    rep = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(lg, -1), vr)
    rep = rep.reshape(B, 1, hq * hd) @ tp["wo"]
    _close(out, rep, "grouped vs repeated")
    jout, jk, jv = j_attn.decode_attention(p, jnp.asarray(x), jnp.asarray(ck),
                                           jnp.asarray(cv), jnp.int32(pos), cfg)
    _close(out, jout, "grouped vs reference")
    _close(k2, jk, "k written")
    _close(v2, jv, "v written")


def test_position_past_a_full_cache_raises():
    """Without a window, a position at or past max_seq has no slot.  The
    reference's scatter drops the write (JAX drops an out-of-bounds
    update) and attends over the stale cache; the port refuses."""
    cfg, tcfg, jmodel, tmodel, params = _setup("smollm-360m")
    jc = jmodel.init_cache(B, 4)
    tok = np.ones((B, 1), np.int32)
    for t in range(4):
        _, jc = jmodel.decode_step(params, jc, jnp.asarray(tok), jnp.int32(t))
    before = jax.tree_util.tree_map(np.asarray, jc)
    _, jc2 = jmodel.decode_step(params, jc, jnp.asarray(tok), jnp.int32(4))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(jc2)):
        np.testing.assert_array_equal(a, np.asarray(b))   # the write dropped
    assert not np.asarray(jnp.zeros((1, 4)).at[:, 6].set(1.0)).any()
    tparams = params_from_numpy(params, CPU)
    tc = tmodel.init_cache(B, 4, CPU)
    for t in range(4):
        _, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), t)
    with pytest.raises(ValueError, match="position 4 .* span 4"):
        tmodel.decode_step(tparams, tc, torch.from_numpy(tok), 4)
    # A windowed arch wraps instead.
    wmodel = t_build(t_reduced("mixtral-8x22b"))
    wc = wmodel.init_cache(B, 40, CPU)
    assert wc["k"].shape[2] == 32
    wmodel.decode_step(wmodel.init(0, CPU), wc, torch.from_numpy(tok), 39)


def test_cache_interop_round_trip():
    """The reference's cache after a few steps -> the port -> numpy, leaf
    for leaf, for each layout; and a port decode from the carried cache
    continues as the reference's does."""
    for arch in ("whisper-base", "qwen2-7b", "rwkv6-3b", "zamba2-2.7b"):
        cfg, tcfg, jmodel, tmodel, params = _setup(arch)
        tparams = params_from_numpy(params, CPU)
        jc, _ = _caches(cfg, jmodel, tmodel, params, tparams, 8)
        tok = np.full((B, 1), 3, np.int32)
        for t in range(3):
            _, jc = jmodel.decode_step(params, jc, jnp.asarray(tok),
                                       jnp.int32(t))
        as_np = jax.tree_util.tree_map(np.asarray, jc)
        tc = cache_from_numpy(as_np, CPU)
        back = cache_to_numpy(tc)
        for a, b in zip(jax.tree_util.tree_leaves(as_np), tree_leaves(back)):
            np.testing.assert_array_equal(a, b)
        jl, _ = jmodel.decode_step(params, jc, jnp.asarray(tok), jnp.int32(3))
        tl, _ = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), 3)
        _close(tl, jl, f"{arch} after the carry")
    with pytest.raises(ValueError, match="not a decode cache"):
        cache_from_numpy({"k": np.zeros(1)})


def test_launch_serve_runs_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--arch", "smollm-360m",
                      "--batch", "2", "--prompt", "4", "--max-new", "5"])
    assert out["tokens"].shape == (2, 5) and len(out["step_ms"]) == 4
    assert "ms per decoded token" in capsys.readouterr().out
    out = serve.main(["--device", "cpu", "--arch", "whisper-base",
                      "--layers", "1", "--batch", "2", "--prompt", "3",
                      "--max-new", "3"])
    assert out["cfg"].num_layers == 1 and out["tokens"].shape == (2, 3)
    assert "depth cut: 1 of 2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_matches_reference(arch):
    """total_params / active_params / model_flops of the full configs equal
    the reference's; RooflineTerms agrees on the same numbers."""
    jcfg, tcfg = j_get(arch), t_get(arch)
    assert t_roof.total_params(tcfg) == j_roof.total_params(jcfg)
    assert t_roof.active_params(tcfg) == j_roof.active_params(jcfg)
    assert t_roof.model_flops(tcfg, 4096) == j_roof.model_flops(jcfg, 4096)
    nums = (3.1e15, 2.2e11, 4.0e9, 989e12, 3.35e12, 4.5e11)
    jt, tt = j_roof.RooflineTerms(*nums), t_roof.RooflineTerms(*nums)
    assert tt.as_dict() == jt.as_dict()
    terms = t_roof.decode_step_terms(tcfg, 4, 128, 100)
    assert terms.dominant == "memory" and terms.coll_bytes == 0


def test_decode_step_bytes_count_what_a_step_reads():
    """decode_step_terms' bytes, written out for a dense bf16 config: the
    weights but the embedding table (its B rows), the live KV slots read
    plus one written, and the fp32 logits; MoE counts the experts read."""
    cfg = t_get("qwen2-7b")
    b, pos = 8, 300
    wbytes = 2 * (t_roof.total_params(cfg) - 152064 * 3584 + b * 3584)
    kv = cfg.num_layers * b * 4 * 128 * 2 * 2 * (pos + 1 + 1)
    logits = b * 152064 * 4
    terms = t_roof.decode_step_terms(cfg, b, 384, pos)
    assert terms.hbm_bytes == wbytes + kv + logits
    moe = t_get("mixtral-8x22b").replace(num_layers=2)
    full = t_roof.decode_step_terms(moe, 4, 128, 10).hbm_bytes
    half = t_roof.decode_step_terms(moe, 4, 128, 10,
                                    experts_read=8.0).hbm_bytes
    expert = 3 * 6144 * 16384 * 2
    assert full - half == pytest.approx(8 * expert)
