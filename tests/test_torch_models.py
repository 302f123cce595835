"""The port's model zoo against the reference's, on the CPU: the
attention family (dense, MoE, VLM) here; every arch's config, full-size
tree and remat; the SSM, hybrid and encoder-decoder families' numerics
are tests/test_torch_families.py's.

Both packages run the reduced configs (fp32) from the same parameters:
the reference's init carried across with ``repro_torch.interop``, with
random QKV biases written into the numpy tree first (their init is zeros,
which would hide them).  Tolerance: 1e-5 of the largest magnitude (the
logits' over the whole (B, S, V) array; a scalar loss is its own
magnitude): both sum fp32 products in another order, and the difference
compounds over two layers.  The window tests run at seq 64, where a
window of 32 binds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.models import build_model as j_build
from repro.models.common import abstract
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import build_model as t_build
from repro_torch.models import moe as t_moe
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(2)
CPU = torch.device("cpu")
TOL = 1e-5

#: The archs this slice added (smollm-360m came with slice 1).
NEW_ARCHS = ("qwen2-7b", "codeqwen1.5-7b", "minitron-8b", "mixtral-8x22b",
             "arctic-480b", "internvl2-2b")
ATTENTION_ARCHS = ("smollm-360m",) + NEW_ARCHS
#: Every arch the reference registers.
ALL_ARCHS = ATTENTION_ARCHS + ("rwkv6-3b", "zamba2-2.7b", "whisper-base")
B, S = 2, 64


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _same_config(t: ModelConfig, j) -> None:
    for name in ModelConfig.__dataclass_fields__:
        got, want = getattr(t, name), getattr(j, name)
        if name == "dtype":
            assert _dtype_name(got) == _dtype_name(want), name
        else:
            assert got == want, (name, got, want)
    assert t.is_attention_free == j.is_attention_free
    assert t.supports_long_decode() == j.supports_long_decode()


def test_registry_holds_the_attention_family():
    """The registry holds the reference's ten archs, in its order, the
    attention family among them; build_model builds each one's family."""
    assert ARCH_IDS == J_ARCH_IDS
    assert set(ATTENTION_ARCHS) < set(ALL_ARCHS) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        model = t_build(t_get(arch))
        assert model.cfg.family == j_get(arch).family
        assert type(model).__name__ == type(j_build(j_get(arch))).__name__
    with pytest.raises(ValueError, match="unknown family"):
        t_build(t_get("smollm-360m").replace(family="cnn"))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_equals_reference(arch):
    """Every field the port has, full and reduced (dtype by name)."""
    _same_config(t_get(arch), j_get(arch))
    _same_config(t_reduced(arch), j_reduced(arch))


def test_input_shapes_equal_reference():
    from repro.configs import SHAPES as J_SHAPES
    assert list(SHAPES) == list(J_SHAPES)
    for k, v in SHAPES.items():
        assert isinstance(v, InputShape)
        assert (v.name, v.seq_len, v.global_batch, v.kind) == \
            (J_SHAPES[k].name, J_SHAPES[k].seq_len, J_SHAPES[k].global_batch,
             J_SHAPES[k].kind)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_descs_match_reference_at_full_size(arch):
    """Leaf order (jax's keystr paths), shapes and dtypes of the FULL
    config's tree; nothing is allocated on either side."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        abstract(j_build(j_get(arch)).param_descs()))
    descs = t_build(t_get(arch)).param_descs()
    assert tree_paths(descs) == [jax.tree_util.keystr(p) for p, _ in flat]
    for d, (_, s) in zip(tree_leaves(descs), flat):
        assert tuple(d.shape) == tuple(s.shape)
        assert _dtype_name(d.dtype) == _dtype_name(s.dtype)


def _setup(arch: str, seed: int = 0, **replace):
    """Both models of a reduced config (``replace`` applied to both) and
    the reference's init as numpy, QKV biases made random."""
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    if replace:
        jcfg, tcfg = jcfg.replace(**replace), tcfg.replace(**replace)
    jmodel, tmodel = j_build(jcfg), t_build(tcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    if jcfg.qkv_bias:
        attn = params["blocks"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = (0.5 * rng.standard_normal(attn[k].shape)).astype(np.float32)
    return jcfg, jmodel, tmodel, params


def _batch(cfg, seed: int = 0, lead=(B,)) -> dict:
    rng = np.random.default_rng(seed)
    s = S - cfg.num_patches if cfg.family == "vlm" else S
    tokens = rng.integers(0, cfg.vocab_size, lead + (s,)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, lead + (s,)).astype(np.int32)
    labels[..., :3] = -1                       # masked positions
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            lead + (cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            lead + (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _t_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _forward_and_loss_match(arch: str, **replace):
    jcfg, jmodel, tmodel, params = _setup(arch, **replace)
    batch = _batch(jcfg)
    tparams, tbatch = params_from_numpy(params, CPU), _t_batch(batch)
    jl, jm = jax.jit(jmodel.loss)(params, batch)
    with torch.no_grad():
        tl, tm = tmodel.loss(tparams, tbatch)
        logits = tmodel.forward(tparams, tbatch)
    _close(logits, jax.jit(jmodel.forward)(params, batch), "forward")
    _close(tl, jl, "loss")
    _close(tm["ce"], jm["ce"], "ce")
    _close(tm["aux"], jm["aux"], "aux")
    return jcfg, tm


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_reduced_forward_and_loss_match_reference(arch):
    cfg, tm = _forward_and_loss_match(arch)
    assert (float(tm["aux"]) > 0) == (cfg.family == "moe")
    if cfg.qkv_bias:
        # The biases carried across are the random ones.
        _, _, _, params = _setup(arch)
        assert np.abs(params["blocks"]["attn"]["bq"]).min() > 0


def test_sliding_window_limits_attention():
    """The reference's test, on the port: tokens beyond the window do not
    reach the output; tokens inside it do."""
    cfg = t_reduced("mixtral-8x22b").replace(sliding_window=4,
                                             num_experts=0, family="dense")
    model = t_build(cfg)
    params = model.init(4, CPU)
    rng = np.random.default_rng(4)
    t1 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)))
    t2 = t1.clone()
    t2[:, 0] = (t1[0, 0] + 1) % cfg.vocab_size
    with torch.no_grad():
        l1 = model.forward(params, {"tokens": t1})
        l2 = model.forward(params, {"tokens": t2})
    # position 11 attends to [8..11] only -> unchanged by token 0
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    # position 2 is inside token 0's window -> must change
    assert float((l1[:, 2] - l2[:, 2]).abs().max()) > 1e-4


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_window_32_at_seq_64_matches_reference_and_binds(family):
    """Reduced mixtral's window (32) at seq 64, as a MoE and as a dense
    model: parity with the reference, and the window changes the logits
    (so it was applied, not vacuous)."""
    replace = {} if family == "moe" else dict(num_experts=0, family="dense")
    cfg, _ = _forward_and_loss_match("mixtral-8x22b", **replace)
    assert cfg.sliding_window == 32 and S == 64
    _, _, tmodel, params = _setup("mixtral-8x22b", **replace)
    tparams, tbatch = params_from_numpy(params, CPU), _t_batch(_batch(cfg))
    full = t_build(tmodel.cfg.replace(sliding_window=None))
    with torch.no_grad():
        a = tmodel.forward(tparams, tbatch)
        b = full.forward(tparams, tbatch)
    assert torch.equal(a[:, :32], b[:, :32])
    assert float((a[:, 32:] - b[:, 32:]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_moe_drops_tokens_at_capacity_factor_half(arch):
    """capacity_factor = 0.5: the groups overflow (S k > E cap), tokens
    drop (zero gate weight), and forward / loss still match."""
    cfg = t_reduced(arch).replace(capacity_factor=0.5)
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = int(cfg.capacity_factor * S * k / e) + 1
    assert S * k > e * cap
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    probs = torch.softmax(torch.randn((B, S, e), generator=gen), dim=-1)
    buf, flat, pos, w = t_moe._dispatch(x, probs, k, cap)
    dropped = w == 0
    assert dropped.any() and not dropped.all()
    # Each kept (token, choice) owns its slot; dropped ones add zero rows.
    kept = ~dropped
    for g in range(B):
        slots = set(zip(flat[g][kept[g]].tolist(), pos[g][kept[g]].tolist()))
        assert len(slots) == int(kept[g].sum())
    _forward_and_loss_match(arch, capacity_factor=0.5)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = t_moe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch):
    """Activation checkpointing recomputes the same ops: loss and every
    gradient equal to the last bit (the hybrid's Mamba2 and shared blocks
    each wrapped; whisper does not read remat, as the reference)."""
    cfg = t_reduced(arch)
    batch = _t_batch(_batch(cfg))
    out = []
    for remat in (False, True):
        model = t_build(cfg.replace(remat=remat))
        params = model.init(0, CPU)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, m = model.loss(params, batch)
        out.append((loss.detach(), m["aux"].detach(),
                    torch.autograd.grad(loss, leaves)))
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
