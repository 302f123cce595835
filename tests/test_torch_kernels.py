"""The port's kernels (K1 gram, K2 mixtrim, K3 combine) against the JAX
package's.

On the CPU each wrapper runs its plain version, so these tests hold the
plain versions to ``repro.kernels.*.ref`` on a seeded sweep, and one case
of each to the Pallas kernel in interpret mode.  Tolerances (the
reference's exactness contracts, docs/perf.md):

* fp32: <= 1e-5 relative to the largest magnitude of the reference output
  (fp32-dot tightness: the sums run in another order than XLA's);
* bf16 inputs widen to fp32 exactly in both packages, so they are held to
  the same fp32 tolerance.

The reference's own bitwise sub-block gram check fails at the seed and is
not copied.  The CUDA kernels against their plain versions are in
tests/test_torch_cuda.py, which imports no JAX so it runs on a GPU host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.combine import combine as jcombine
from repro.kernels.combine import combine_ref as jcombine_ref
from repro.kernels.gram import gram as jgram
from repro.kernels.gram import gram_ref as jgram_ref
from repro.kernels.mixtrim import mixtrim as jmixtrim
from repro.kernels.mixtrim import mixtrim_dyn_ref as jmixtrim_dyn_ref
from repro.kernels.mixtrim import mixtrim_ref as jmixtrim_ref
from repro_torch.kernels import combine, gram, mixtrim, mixtrim_dyn
from repro_torch.kernels import dispatch as kdispatch

torch.set_num_threads(2)

FP32_RTOL = 1e-5


def _close(got, want, rtol=FP32_RTOL):
    """Same NaN positions, same infinities, and finite entries within
    ``rtol`` of the largest finite magnitude of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    scale = max(float(np.abs(want[fin]).max()), 1e-30) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=rtol * scale)


def _stack(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _both(x, bf16=False):
    """The same values as a jnp array and a torch tensor (bf16-rounded in
    both when ``bf16``)."""
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return jx, (tx.to(torch.bfloat16) if bf16 else tx)


def _mix(seed, n):
    z = np.random.default_rng(seed + 1).normal(size=(n, n))
    m = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    return m.astype(np.float32)


@pytest.mark.parametrize("n", [8, 17])
@pytest.mark.parametrize("bf16", [False, True])
def test_gram_plain_matches_reference(n, bf16):
    jx, tx = _both(_stack(n, n, 777), bf16)
    _close(gram(tx).numpy(), jgram_ref(jx))


@pytest.mark.parametrize("n", [8, 17])
@pytest.mark.parametrize("bf16", [False, True])
def test_combine_plain_matches_reference(n, bf16):
    jx, tx = _both(_stack(n, n, 777), bf16)
    c = np.random.default_rng(3).dirichlet(np.ones(n)).astype(np.float32)
    _close(combine(tx, torch.from_numpy(c)).numpy(),
           jcombine_ref(jx, jnp.asarray(c)))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 17, 31, 33, 48, 64])
@pytest.mark.parametrize("mode", ["trim", "med"])
@pytest.mark.parametrize("mix", [False, True])
def test_mixtrim_plain_matches_reference(n, mode, mix):
    """One n per height class of the n <= 64 body K2 shares with K4 on the
    card (four columns a thread to n = 8, two to 20, one above; one
    instance per n to 32, the 48- and 64-high ones above), in every f
    regime."""
    jx, tx = _both(_stack(n, n, 300))
    m = _mix(n, n) if mix else None
    for f in sorted({0, min(2, (n - 1) // 2), (n - 1) // 2}):
        got = mixtrim(tx, None if m is None else torch.from_numpy(m), f, mode)
        want = jmixtrim_ref(jx, None if m is None else jnp.asarray(m), f, mode)
        _close(got.numpy(), want)


def test_mixtrim_plain_bf16_stack():
    """bf16 stack with M rounded to bf16 first (the robust pipeline's
    transport contract)."""
    jx, tx = _both(_stack(5, 17, 200), bf16=True)
    m = np.array(jnp.asarray(_mix(5, 17), jnp.bfloat16).astype(jnp.float32))
    got = mixtrim(tx, torch.from_numpy(m).to(torch.bfloat16), 8, "trim")
    _close(got.numpy(), jmixtrim_ref(jx, jnp.asarray(m, jnp.bfloat16), 8, "trim"))


@pytest.mark.parametrize("fill", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("mode", ["trim", "med"])
def test_mixtrim_plain_nonfinite_rows_match_reference(fill, mode):
    """nan / inf attack rows: both sort NaN last, so the trim drops the f
    Byzantine rows and the output stays finite; the kernel is held to this
    plain version on the card."""
    n, f = 17, 8
    x = _stack(7, n, 64)
    x[n - f:] = fill
    got = mixtrim(torch.from_numpy(x), None, f, mode).numpy()
    want = np.asarray(jmixtrim_ref(jnp.asarray(x), None, f, mode))
    _close(got, want)
    if mode == "trim":
        assert np.isfinite(got).all()


@pytest.mark.parametrize("n", [8, 17, 33, 64])
@pytest.mark.parametrize("mode", ["trim", "med"])
def test_mixtrim_slice_and_dyn_mask_on_nonfinite_stacks_match_reference(
        n, mode):
    """K2 trims a slice of ranks, K4 multiplies every rank by a 0-1 mask;
    the body they share on the card keeps that difference.  Columns 0-49
    hold +inf in the top rank and -inf in the bottom one (both trimmed),
    50-99 hold f NaNs (the top f ranks, trimmed), 100-149 f + 1 NaNs (one
    reaches a kept rank), the rest are finite.  Each plain version against
    the reference's oracle; in the trim, K2 is finite where K4 is NaN
    (inf * 0, NaN * 0) in the first two groups, and both are NaN in the
    third."""
    f = max(1, n // 4)
    x = _stack(n + 41, n, 200)
    x[n - 1, :50] = np.inf
    x[0, :50] = -np.inf
    x[:f, 50:100] = np.nan
    x[:f + 1, 100:150] = np.nan
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    k = f if mode == "trim" else 0
    got2 = mixtrim(tx, None, k, mode).numpy()
    _close(got2, jmixtrim_ref(jx, None, k, mode))
    got4 = mixtrim_dyn(tx, None, torch.tensor(k, dtype=torch.int32),
                       mode).numpy()
    _close(got4, jmixtrim_dyn_ref(jx, None, k, mode))
    if mode == "trim":
        assert np.isfinite(got2[:100]).all() and np.isnan(got4[:100]).all()
        assert np.isnan(got2[100:150]).all() and np.isnan(got4[100:150]).all()
        assert np.isfinite(got2[150:]).all()
        _close(got2[150:], got4[150:])


@pytest.mark.parametrize("n", [100, 640])
@pytest.mark.parametrize("mode", ["trim", "med"])
@pytest.mark.parametrize("mix", [False, True])
def test_mixtrim_plain_above_64_workers_matches_reference(n, mode, mix):
    """The range of the tiled mix and rank selection on the card
    (64 < n <= 1024): the plain version, which the kernel is held to
    there, against the reference's oracle in every f regime."""
    jx, tx = _both(_stack(n, n, 257))
    m = _mix(n, n) if mix else None
    for f in sorted({0, 3, n // 32, (n - 1) // 2}) if mode == "trim" else (0,):
        got = mixtrim(tx, None if m is None else torch.from_numpy(m), f, mode)
        want = jmixtrim_ref(jx, None if m is None else jnp.asarray(m), f, mode)
        _close(got.numpy(), want)


@pytest.mark.parametrize("n,f", [(17, 4), (100, 10)])
@pytest.mark.parametrize("mode", ["trim", "med"])
def test_plain_versions_rank_sign_bit_nan_last(n, f, mode):
    """A NaN with its sign bit set (a negated NaN row) ranks last, as in
    jnp.sort: K2's and K4's plain versions and the torch backend's cwtm
    against the reference, beside +NaN and inf rows."""
    from repro.core import aggregators as jagg
    from repro_torch.core import aggregators
    x = _stack(n + 3, n, 301)
    x[n - f:, ::2] = np.nan
    x[1, 11:200] = np.copysign(np.float32(np.nan), np.float32(-1))
    x[2, 150:170] = np.inf
    assert np.signbit(x[1, 11]) and np.isnan(x[1, 11])
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    k = f if mode == "trim" else 0
    _close(mixtrim(tx, None, k, mode).numpy(), jmixtrim_ref(jx, None, k, mode))
    fl = [k, n // 2 + 1]
    got = mixtrim_dyn(torch.stack([tx, tx]), None,
                      torch.tensor(fl, dtype=torch.int32), mode).numpy()
    for i, fi in enumerate(fl):
        _close(got[i], jmixtrim_dyn_ref(jx, None, fi, mode))
    if mode == "trim":
        _close(aggregators.cwtm(tx, f).numpy(), jagg.cwtm(jx, f))


def _tie_stack(kind, n, d, seed):
    """Tie-heavy columns: 0-1 entries at a density drawn per column, or
    small integers in [-3, 3] (every sum exact in fp32)."""
    rng = np.random.default_rng(seed)
    if kind == "01":
        return (rng.random((n, d)) < rng.random((1, d))).astype(np.float32)
    return rng.integers(-3, 4, size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["01", "int"])
@pytest.mark.parametrize("mode", ["trim", "med"])
def test_mixtrim_plain_tie_heavy_columns_equal_reference_exactly(kind, mode):
    """n = 640 on tie-heavy columns, static f and K4's per-lane f (past
    n/2 too): the plain versions are exact.  The static trim equals the
    correctly rounded mean of the sorted slice (float64 sums of integers
    are exact; the reference's jnp mean can differ from it in the last
    bit, so it is held to the reference within the fp32 tolerance), the
    median and K4's masked sum over max(n - 2f, 1) equal the reference's
    oracles exactly.  On the card the rank selection is held to these
    plain versions exactly (tests/test_torch_cuda.py), which is where a
    selection that miscounts ties would show."""
    n, d = 640, 300
    x = _tie_stack(kind, n, d, seed=11)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    xs = np.sort(x, axis=0).astype(np.float64)
    for f in (0, 3, n // 32, 200, (n - 1) // 2) if mode == "trim" else (0,):
        got = mixtrim(tx, None, f, mode).numpy()
        want = jmixtrim_ref(jx, None, f, mode)
        if mode == "med":
            np.testing.assert_array_equal(got, np.asarray(want))
            continue
        exact = (xs[f: n - f].sum(axis=0) / (n - 2 * f)).astype(np.float32)
        np.testing.assert_array_equal(got, exact)
        _close(got, want)
    fl = [0, 3, n // 32, (n - 1) // 2, n // 2, n // 2 + 7]
    got = mixtrim_dyn(tx.expand(len(fl), n, d).contiguous(), None,
                      torch.tensor(fl, dtype=torch.int32), mode).numpy()
    for k, f in enumerate(fl):
        np.testing.assert_array_equal(
            got[k], np.asarray(jmixtrim_dyn_ref(jx, None, f, mode)))


def test_one_case_each_against_interpret_mode_pallas():
    n, f = 17, 8
    jx, tx = _both(_stack(11, n, 300))
    m = _mix(11, n)
    c = np.random.default_rng(4).dirichlet(np.ones(n)).astype(np.float32)
    _close(gram(tx).numpy(), jgram(jx, block_d=128, interpret=True))
    _close(combine(tx, torch.from_numpy(c)).numpy(),
           jcombine(jx, jnp.asarray(c), block_d=128, interpret=True))
    _close(mixtrim(tx, torch.from_numpy(m), f, "trim").numpy(),
           jmixtrim(jx, jnp.asarray(m), f=f, mode="trim", block_d=128,
                    interpret=True))


def test_wrappers_refuse_non_cuda_accelerator_tensors():
    """A wrapper runs its plain version only for a CPU tensor; any other
    device must launch the kernel or raise, never fall back."""
    x = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gram(x)
    with pytest.raises(ValueError, match="CUDA"):
        combine(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        mixtrim(x, None, 2, "trim")


def test_flatten_matches_reference_order_and_is_zero_copy_on_views():
    from repro.kernels.dispatch import flatten_worker_stack as jflatten
    rng = np.random.default_rng(0)
    tree = {"b": {"z": rng.normal(size=(4, 3, 2)), "a": rng.normal(size=(4, 5))},
            "a": rng.normal(size=(4,))}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    jflat, _ = jflatten(jax.tree_util.tree_map(jnp.asarray, tree))
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    flat, layout = kdispatch.flatten_worker_stack(ttree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    views = kdispatch.stack_views(flat, layout)
    again, _ = kdispatch.flatten_worker_stack(views)
    assert again.data_ptr() == flat.data_ptr()
    vec = torch.arange(layout.width, dtype=torch.float32)
    back = kdispatch.unflatten_aggregate(vec, layout)
    assert back["b"]["z"].shape == (3, 2)
    assert float(back["a"]) == 0.0


# --- K3's launch geometry and the wrappers' launch helpers (no card) --------

from repro_torch.kernels import _build, _common  # noqa: E402
from repro_torch.kernels.combine import ops as combine_ops  # noqa: E402

GEOMETRY_DS = sorted({1, 2, 3, 4, 5, 7, 8, 31, 32, 33, 127, 128, 129, 1000,
                      2841, 2842, 2844, 4096, 4099, 8191, 8192, 16384,
                      (1 << 18) + 3, 1 << 20, (1 << 20) + 2, (1 << 24) + 3,
                      1 << 24, 361_821_120, 1 << 26, (1 << 26) + 2,
                      (1 << 26) + 3})


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("d", GEOMETRY_DS)
def test_k3_launch_geometry_covers_every_column(d, sms):
    """For every load width that divides D: threads a multiple of 32 (32 to
    256), blocks within the grid's x limit and 16 an SM, and the
    grid-stride loop of csrc/combine.cu visiting each of the D / vec units
    (so each column) exactly once.  The visit counts are computed up to
    2^20 columns; above that every unit u is visited by thread u mod
    (blocks * threads) alone, which needs only blocks * threads >= 1."""
    for vec in (4, 2, 1):
        if d % vec:
            continue
        threads, blocks = combine_ops.launch_geometry(d, vec, sms)
        assert threads % 32 == 0 and 32 <= threads <= 256
        assert 1 <= blocks <= min(16 * sms, 2 ** 31 - 1)
        units = d // vec
        assert units * vec == d
        stride = threads * blocks
        if units <= 1 << 20:
            starts = np.arange(min(stride, units))
            trips = -(-(units - starts) // stride)
            visits = np.zeros(units, np.int64)
            for k in range(int(trips.max())):
                u = starts[trips > k] + k * stride
                visits[u] += 1
            assert (visits == 1).all()
            cols = (np.arange(units)[:, None] * vec + np.arange(vec)).ravel()
            np.testing.assert_array_equal(cols, np.arange(d))
        if units >= 256 * sms:      # a large lane keeps 256 threads
            assert threads == 256
        if units <= 32 * 16 * sms:  # a small lane: one unit a thread
            assert stride >= units


def test_k3_load_width_is_the_widest_every_row_allows():
    lw = combine_ops.load_width
    assert lw(0, 0, 2842, 4) == 2          # the grid's D, fp32: 8-byte loads
    assert lw(0, 0, 2844, 4) == 4
    assert lw(0, 0, 2841, 4) == 1
    assert lw(4, 0, 2844, 4) == 1          # fp32 base one element past 16 B
    assert lw(8, 0, 2844, 4) == 2
    assert lw(2, 0, 2844, 2) == 1          # bf16 base one element past 8 B
    assert lw(4, 0, 2844, 2) == 2
    assert lw(8, 0, 2844, 2) == 4
    assert lw(0, 8, 2844, 4) == 2          # the output row bounds it too
    for d in GEOMETRY_DS:
        for item in (2, 4):
            for x_off in range(0, 16, item):
                vec = lw(x_off, 0, d, item)
                assert d % vec == 0 and x_off % (vec * item) == 0


class _FakeLib:
    """Records the arguments of repro_combine instead of launching: the
    pointers, the stream and the plan's fields."""

    def __init__(self):
        self.calls = []

    def repro_combine(self, x, coeff, out, plan, stream):
        p = combine_ops.Plan.from_address(plan)
        self.calls.append((x, coeff, out, stream, p.dtype, p.lanes, p.n,
                           p.d, p.vec, p.threads, p.blocks))
        return 0


@pytest.mark.parametrize("d,misaligned,vec", [(2842, False, 2),
                                              (2844, False, 4),
                                              (2841, False, 1),
                                              (2844, True, 1)])
def test_k3_host_path_geometry_is_the_same_whatever_b(monkeypatch, d,
                                                      misaligned, vec):
    """K3's host path, driven on CPU tensors with the C entry recorded: the
    load width, block size and column blocks a lane gets are the same for
    B = 1, 5, 13 and 65535, the lane count goes to the grid's y, and the
    pointers, the stream and the dtype code are passed as they are."""
    fake = _FakeLib()
    combine_ops._plan.cache_clear()
    monkeypatch.setattr(_build, "_LIB", fake)
    monkeypatch.setitem(_build._SM_COUNT, -1, 132)
    monkeypatch.setattr(combine_ops, "device_guard",
                        lambda x: _common._NO_GUARD)
    monkeypatch.setattr(combine_ops, "stream_of", lambda x: 4242)
    geoms = set()
    for b in (1, 5, 13, 65535):
        n = 3 if b > 13 else 17
        base = torch.zeros(b * n * d + int(misaligned))
        x = base[int(misaligned):].view(b, n, d)
        c = torch.zeros((b, n))
        out = combine_ops._launch(x, c, (b, n), b, n, d, (b, d))
        assert out.shape == (b, d) and out.dtype == torch.float32
        args = fake.calls[-1]
        assert args[:4] == (x.data_ptr(), c.data_ptr(), out.data_ptr(), 4242)
        assert args[4:8] == (0, b, n, d)
        assert args[8:] == (vec, *combine_ops.launch_geometry(d, vec, 132))
        geoms.add(args[8:])
    assert len(geoms) == 1
    x1 = torch.zeros(17 * d + int(misaligned))[int(misaligned):].view(17, d)
    combine_ops._launch(x1.bfloat16(), torch.zeros(17), (17,), 1, 17, d, (d,))
    assert fake.calls[-1][4:8] == (1, 1, 17, d)
    combine_ops._plan.cache_clear()


def test_check_lanes_messages_and_lane_limit():
    """check_lanes reads the (B, n, D) tensor itself, with the messages of
    check_stack on a lane; at most 65535 lanes (the grid's y)."""
    meta = lambda *shape: torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match=r"expected a \(B, n, D\) stack"):
        _common.check_lanes(meta(17, 8), "k")
    with pytest.raises(ValueError, match="need 1 <= B <= 65535 lanes, got 0"):
        _common.check_lanes(meta(0, 17, 8), "k")
    with pytest.raises(ValueError, match="need 1 <= B <= 65535 lanes, got 65536"):
        _common.check_lanes(meta(65536, 1, 1), "k")
    with pytest.raises(ValueError, match="k: expected a CUDA tensor, got meta"):
        _common.check_lanes(meta(65535, 1, 1), "k")
    with pytest.raises(ValueError, match="expected a CUDA tensor, got cpu"):
        _common.check_lanes(torch.zeros((2, 3, 4)), "k")


def test_sm_count_is_cached_per_device_index(monkeypatch):
    asked = []

    def props(index):
        asked.append(index)
        return type("P", (), {"multi_processor_count": 100 + index})()

    monkeypatch.setattr(_build, "_SM_COUNT", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert _build.sm_count(torch.device("cuda", 0)) == 100
    assert _build.sm_count(0) == 100
    assert _build.sm_count(torch.device("cuda", 1)) == 101
    assert _build.sm_count(torch.device("cuda")) == 101   # the current card
    assert _build.sm_count(torch.device("cuda", 0)) == 100
    assert asked == [0, 1]


def test_stream_and_guard_helpers_build_no_stream_or_context(monkeypatch):
    """stream_of reads the raw handle of x's card's current stream without
    a torch.cuda.Stream; device_guard enters torch.cuda.device only when x
    lies on another card than the current one."""
    asked = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: asked.append(index) or 1000 + index,
                        raising=False)

    def no_stream(*a, **k):
        raise AssertionError("built a torch.cuda.Stream")

    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    monkeypatch.setattr(torch.cuda, "current_stream", no_stream)
    on = lambda k: type("T", (), {"get_device": lambda self: k,
                                  "device": torch.device("cuda", k)})()
    assert _common.stream_of(on(1)) == 1001 and asked == [1]
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    assert _common.device_guard(on(0)) is _common._NO_GUARD
    guard = _common.device_guard(on(1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1
