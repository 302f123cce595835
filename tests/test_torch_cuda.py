"""The CUDA kernels K1-K7 and the lane forms of K2's median, K3, K6 and K7
against their plain versions, on the card.

Every test here is marked ``cuda`` and skips with a reason without a GPU
(the kernels have no CPU mode).  The file imports no JAX, so it runs on a
GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the largest finite |plain| (fp32 sums in another
order); NaN positions and infinities must agree exactly.  Bucket means of a
bf16 stack are rounded to bf16 from fp32 sums taken in another order, so
a value that lies at a rounding boundary may land one bf16 step away:
each is held to one bf16 ulp (2^-7 of the value) on top of that fp32
tolerance (a mean near 0 after cancellation has an ulp far below the
fp32 sums' rounding).
"""
import pytest
import torch

from repro_torch.kernels import (
    bucket_means_gram, bucket_means_gram_lanes_ref, bucket_means_gram_ref,
    bucketgram, bucketgram_lanes, bucketgram_lanes_perms, bucketmeans,
    bucketmeans_lanes, bucketmeans_lanes_perms, combine, combine_lanes,
    combine_lanes_ref, combine_ref, gram, gram_batched, gram_batched_ref,
    gram_ref, mixtrim, mixtrim_dyn, mixtrim_dyn_ref, mixtrim_lanes,
    mixtrim_lanes_ref, mixtrim_ref,
)
from repro_torch.kernels import _build
from repro_torch.kernels.bucketgram import ops as bucketgram_ops
from repro_torch.kernels.bucketgram import perm_assignment

RTOL = 1e-5


def _close(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    if fin.any():
        tol = RTOL * float(want[fin].abs().max())
        assert float((got[fin] - want[fin]).abs().max()) <= tol


def _close_bf16(got, want):
    """One bf16 ulp per entry plus the fp32 tolerance (module docstring)."""
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    tol = RTOL * float(want[fin].abs().max())
    assert bool(((got[fin] - want[fin]).abs()
                 <= 2.0 ** -7 * want[fin].abs() + tol).all())


def _close_means(got, want):
    (_close_bf16 if want.dtype == torch.bfloat16 else _close)(got, want)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _stack(dev, n, d, dtype, misaligned, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = torch.randn(n * d + int(misaligned), generator=gen, device=dev)
    return base[int(misaligned):].to(dtype).view(n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3, 8, 9, 17, 32, 33, 40, 64, 65, 100, 127,
                               128, 129, 256, 640, 1024])
@pytest.mark.parametrize("d", [1, 7, 1000, 4099, (1 << 20) + 3])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernels_match_plain_versions(dev, dtype, n, d, misaligned):
    """Vector and scalar paths (d % 4, misaligned base), every sort height
    (n = 1 .. 64), and every route of K1: the one-tile kernel (n <= 8), the
    staged kernel (8 < n <= 32) and the tiled product (n > 32: TM = 32,
    64 and 128, ragged last row tiles, diagonal and off-diagonal pairs).
    K2 above 64 workers has its own tests."""
    x = _stack(dev, n, d, dtype, misaligned, seed=n * 7919 + d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    c = torch.rand(n, generator=gen, device=dev)
    m = torch.softmax(torch.randn(n, n, generator=gen, device=dev), -1)
    _close(gram(x), gram_ref(x))
    _close(combine(x, c), combine_ref(x, c))
    if n > 64:
        return
    for mode in ("trim", "med"):
        for f in sorted({0, min(2, (n - 1) // 2), (n - 1) // 2}):
            for mm in (None, m.to(dtype)):
                _close(mixtrim(x, mm, f, mode), mixtrim_ref(x, mm, f, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("n,f", [(8, 2), (17, 8), (33, 16), (64, 31)])
def test_mixtrim_nonfinite_rows_match_plain(dev, fill, n, f):
    """nan / inf attack rows: the kernel ranks NaN last, as torch.sort.
    f such rows are trimmed (the output stays finite); one more row puts a
    NaN or an inf into a kept rank in the second stack."""
    x = _stack(dev, n, 4099, torch.float32, False, seed=1).clone()
    x[n - f:] = fill
    more = x.clone()
    more[n - f - 1] = fill
    m = torch.softmax(torch.randn(n, n, device=dev), -1)
    for mode in ("trim", "med"):
        for mm in (None, m):
            _close(mixtrim(x, mm, f, mode), mixtrim_ref(x, mm, f, mode))
            _close(mixtrim(more, mm, f, mode), mixtrim_ref(more, mm, f, mode))
    assert bool(torch.isfinite(mixtrim(x, None, f, "trim")).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 17, 40, 100, 640])
def test_gram_is_deterministic_and_counts_launches(dev, n):
    """Every route of K1: bitwise equal over two runs, exactly symmetric
    (the upper triangle mirrored), one launch counted per call."""
    x = _stack(dev, n, (1 << 22) + 4 if n <= 100 else (1 << 20) + 4,
               torch.float32, False, seed=2)
    before = gram.launches
    g = gram(x)
    assert torch.equal(g, gram(x))
    assert torch.equal(g, g.T)
    assert gram.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("n", [17, 100, 640])
@pytest.mark.parametrize("d", [4099, 4096])
def test_gram_nonfinite_rows_match_plain(dev, fill, n, d):
    """inf / NaN rows (the attacks' rows, and one stray entry): K1 gives the
    plain contraction's NaN and inf positions, and its infinities' signs."""
    x = _stack(dev, n, d, torch.float32, False, seed=n + 3).clone()
    x[n - 3:, 10:1000] = fill
    x[1, 7] = float("nan")
    x[2, 2000:2100] = -float("inf")
    _close(gram(x), gram_ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [65, 100, 257, 640, 1024, 1025])
@pytest.mark.parametrize("d", [1, 61, 4099])
def test_mixtrim_above_64_workers_matches_plain(dev, dtype, n, d):
    """n > 64: the tiled mix and rank selection up to n = 1024 (every
    tile geometry: rows padded to 256, 640, 1024), the
    shared-memory sort at 1025; every f regime, with and without the mix,
    ragged column tiles."""
    x = _stack(dev, n, d, dtype, False, seed=n + d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    m = torch.softmax(torch.randn(n, n, generator=gen, device=dev), -1)
    for mode in ("trim", "med"):
        for f in sorted({0, 3, n // 32, (n - 1) // 2}):
            if mode == "med" and f:
                continue
            for mm in (None, m.to(dtype)):
                _close(mixtrim(x, mm, f, mode), mixtrim_ref(x, mm, f, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("n,f", [(65, 8), (300, 100)])
def test_mixtrim_above_64_workers_nonfinite_rows(dev, fill, n, f):
    x = _stack(dev, n, 2051, torch.float32, False, seed=4).clone()
    x[n - f:] = fill
    x[3, 7] = float("nan")
    m = torch.softmax(torch.randn(n, n, device=dev), -1)
    for mode in ("trim", "med"):
        for mm in (None, m):
            _close(mixtrim(x, mm, f if mode == "trim" else 0, mode),
                   mixtrim_ref(x, mm, f if mode == "trim" else 0, mode))


def _nnm_m(x, f):
    """The NNM matrix of a (n, D) stack (row i averages its n - f nearest
    rows): f zeros a row, the shape of M on the main path."""
    from repro_torch.core import gram as gramlib
    g = x.float() @ x.float().T
    return gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g), f)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("n,f", [(100, 10), (640, 20)])
def test_mixtrim_above_64_workers_nonfinite_rows_nnm_mix(dev, fill, n, f):
    """NaN / inf rows through an NNM-shaped M (zero entries): the mix
    sums over every j, so 0 * inf = NaN lands where the plain fp32
    product puts it; K2 (slice) and K4 (rank mask, f per lane, past n/2
    too).  Row 5 holds -fill, so with fill = NaN a NaN with its sign bit
    set, which the kernel and the plain versions rank last."""
    x = _stack(dev, n, 2051, torch.float32, False, seed=n).clone()
    m = _nnm_m(x, f)
    assert int((m == 0).sum()) == n * f
    x[n - f:, ::2] = fill
    x[3, 7] = float("nan")
    x[5, 11:40] = -fill
    for mode in ("trim", "med"):
        for mm in (None, m):
            k = f if mode == "trim" else 0
            _close(mixtrim(x, mm, k, mode), mixtrim_ref(x, mm, k, mode))
    xl = torch.stack([x, x, x])
    ml = torch.stack([m, m, m])
    fl = torch.tensor([f, 0, n // 2 + 1], dtype=torch.int32, device=dev)
    for mode in ("trim", "med"):
        for mm in (None, ml):
            _close(mixtrim_dyn(xl, mm, fl, mode), mixtrim_dyn_ref(xl, mm, fl, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(8, 2), (17, 8), (100, 10), (640, 20)])
def test_plain_versions_rank_sign_bit_nan_last_on_the_card(dev, n, f):
    """torch.sort on the card ranks a NaN with its sign bit set first, on
    the CPU last (jnp.sort's order).  The plain versions of K2 and K4 and
    the torch backend's cwtm make NaNs positive before they sort, so on
    the card they equal their CPU runs, and the kernels equal both."""
    from repro_torch.core import aggregators
    from repro_torch.core.robust import _coordinate_rule_lanes
    x = _stack(dev, n, 2051, torch.float32, False, seed=n + 5).clone()
    neg_nan = torch.tensor([-4194304], dtype=torch.int32).view(torch.float32)
    x[n - f:, ::2] = float("nan")
    x[1, 11:300] = neg_nan.to(dev)
    x[2, 200:220] = float("inf")
    assert int(x[1, 11:300].view(torch.int32).min()) < 0
    xc = x.cpu()
    m = torch.softmax(torch.randn(n, n, device=dev), -1)
    for mode in ("trim", "med"):
        k = f if mode == "trim" else 0
        for mm in (None, m):
            want = mixtrim_ref(xc, None if mm is None else mm.cpu(), k, mode)
            _close(mixtrim_ref(x, mm, k, mode), want)
            _close(mixtrim(x, mm, k, mode), want)
    _close(aggregators.cwtm(x, f), aggregators.cwtm(xc, f))
    xl = torch.stack([x, x])
    fl = torch.tensor([f, n // 2 + 1], dtype=torch.int32)
    for mode in ("trim", "med"):
        want = mixtrim_dyn_ref(xl.cpu(), None, fl, mode)
        _close(mixtrim_dyn_ref(xl, None, fl.to(dev), mode), want)
        _close(mixtrim_dyn(xl, None, fl.to(dev), mode), want)
    _close(_coordinate_rule_lanes(xl, "cwtm", fl.to(dev)),
           _coordinate_rule_lanes(xl.cpu(), "cwtm", fl))


def _tie_stack(dev, n, d, kind, seed):
    """Tie-heavy columns: 0-1 entries at a density drawn per column, or
    small integers in [-3, 3] (sums exact in fp32)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if kind == "01":
        p = torch.rand((1, d), generator=gen, device=dev)
        return (torch.rand((n, d), generator=gen, device=dev) < p).float()
    return torch.randint(-3, 4, (n, d), generator=gen, device=dev).float()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["01", "int"])
@pytest.mark.parametrize("mix", [False, True])
def test_mixtrim_rank_select_is_exact_on_tie_heavy_columns(dev, kind, mix):
    """At n = 640, on 0-1 and small-integer columns, with no mix or a
    permutation matrix as M (every sum exact in fp32), the rank selection
    equals the plain version exactly: K2's trim and median, K4's trim (f
    per lane, past n/2 too) and median.  Ties at the two selected ranks
    are what a selection can miscount and a sort cannot.  The plain
    versions run on the CPU, whose mean divides the exact sum once, as the
    kernel does."""
    n, d = 640, 4099
    x = _tie_stack(dev, n, d, kind, seed=n + int(mix))
    m = None
    if mix:
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        perm = torch.randperm(n, generator=gen, device=dev)
        m = torch.eye(n, device=dev)[perm]
    xc, mc = x.cpu(), None if m is None else m.cpu()
    for f in (0, 3, n // 32, 200, (n - 1) // 2):
        for mode in ("trim", "med"):
            k = f if mode == "trim" else 0
            assert torch.equal(mixtrim(x, m, k, mode).cpu(),
                               mixtrim_ref(xc, mc, k, mode))
    fl = torch.tensor([0, 3, n // 32, (n - 1) // 2, n // 2, n // 2 + 7],
                      dtype=torch.int32)
    xl = x.expand(len(fl), n, d).contiguous()
    ml = None if m is None else m.expand(len(fl), n, n).contiguous()
    for mode in ("trim", "med"):
        got = mixtrim_dyn(xl, ml, fl.to(dev), mode).cpu()
        want = mixtrim_dyn_ref(xl.cpu(), None if ml is None else ml.cpu(), fl,
                               mode)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_mixtrim_refuses_more_than_16384_workers(dev):
    x = _stack(dev, 16385, 2, torch.float32, False, seed=3)
    with pytest.raises(ValueError, match="n <= 16384"):
        mixtrim(x, None, 2, "trim")


def _assignment(dev, n, s, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=dev)
    nb = -(-n // s)
    return (torch.argsort(perm) // s).to(torch.int32), nb


def _dense_b(assign, nb):
    n = assign.shape[0]
    counts = torch.bincount(assign.long(), minlength=nb).float()
    b = torch.zeros(nb, n, device=assign.device)
    b[assign.long(), torch.arange(n, device=assign.device)] = 1.0 / counts[assign.long()]
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s", [(16, 2), (17, 2), (10, 4), (5, 5), (40, 3),
                                 (100, 2), (256, 16), (1031, 16), (1280, 2)])
@pytest.mark.parametrize("d", [1, 7, 1000, (1 << 18) + 3])
@pytest.mark.parametrize("misaligned", [False, True])
def test_bucketgram_matches_plain(dev, dtype, n, s, d, misaligned):
    """K6 (means + Gram; register fold for n_b <= 8, K1 on the means above:
    staged to 32 buckets, tiled above, 640 buckets at (1280, 2)) and K7
    (means) against the dense plain version, ragged tail buckets, vector
    and scalar column paths."""
    x = _stack(dev, n, d, dtype, misaligned, seed=n * 31 + d)
    assign, nb = _assignment(dev, n, s, seed=n + s)
    want_y, want_g = bucket_means_gram_ref(x, _dense_b(assign, nb))
    y, g = bucketgram(x, assign, nb)
    assert y.dtype == dtype and g.dtype == torch.float32
    _close_means(y, want_y)
    _close(g, want_g)
    _close_means(bucketmeans(x, assign, nb), want_y)
    y2, g2 = bucket_means_gram(x, _dense_b(assign, nb), with_gram=True)
    _close_means(y2, want_y)
    _close(g2, want_g)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("n,s", [(16, 2), (40, 3)])
def test_bucketgram_nonfinite_rows_spread_like_the_dense_contraction(
        dev, fill, n, s):
    """0 * inf = NaN in the dense B @ X: a non-finite row makes every
    OTHER bucket NaN in its columns; the kernels must do the same."""
    x = _stack(dev, n, 4099, torch.float32, False, seed=5).clone()
    x[2, 100:200] = fill
    x[7, 150:300] = float("inf")
    x[n - 1, 5] = float("nan")
    assign, nb = _assignment(dev, n, s, seed=9)
    want_y, want_g = bucket_means_gram_ref(x, _dense_b(assign, nb))
    y, g = bucketgram(x, assign, nb)
    _close(y, want_y)
    _close(g, want_g)
    _close(bucketmeans(x, assign, nb), want_y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(16, 2), (256, 16)])
def test_bucketgram_gram_is_deterministic_and_counts_launches(dev, n, s):
    x = _stack(dev, n, (1 << 22) + 4, torch.float32, False, seed=6)
    assign, nb = _assignment(dev, n, s, seed=1)
    before, before_m = bucketgram.launches, bucketmeans.launches
    y1, g1 = bucketgram(x, assign, nb)
    y2, g2 = bucketgram(x, assign, nb)
    assert torch.equal(g1, g2) and torch.equal(y1, y2)
    bucketmeans(x, assign, nb)
    assert bucketgram.launches == before + 2
    assert bucketmeans.launches == before_m + 1


def _lanes(dev, b, n, d, dtype, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((b, n, d), generator=gen, device=dev).to(dtype)


def _sum_order_bound(x):
    """Elementwise bound on |A - B| for two fp32 evaluations A, B of the
    same Gram X X^T that differ only in summation order: each is within
    gamma_D * (|X| |X|^T) of the exact value (Higham, Accuracy and
    Stability of Numerical Algorithms, eq. 3.5: any order of D products),
    with gamma_D = D u / (1 - D u), u = 2^-24, so together within twice
    that.  It holds for every chunking, so it does not depend on how K1 and
    K5 split D; a lane offset or a wrong row is off by O(|X| |X|^T)."""
    d = x.shape[-1]
    du = d * 2.0 ** -24
    ax = x.double().abs()
    return 2.0 * du / (1.0 - du) * (ax @ ax.mT)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(1, 8), (5, 17), (5, 9), (8, 16), (3, 40),
                                 (3, 100), (2, 640)])
@pytest.mark.parametrize("d", [1, 7, 2842, (1 << 18) + 3])
def test_gram_batched_matches_plain_and_k1_per_lane(dev, dtype, b, n, d):
    """K5: every lane equals its plain Gram within 1e-5 of that lane's
    max |G| (the fp32 contract), and sums the same products as K1 on that
    lane.  K1 and K5 split D into different chunk counts (the chunk count
    is shared over lanes), so their sums are ordered differently; at
    D = 2^18 that difference reaches 1e-5 of max |G| by itself, so K5 is
    held to K1 by the summation-order bound of :func:`_sum_order_bound`,
    not by the contract's tolerance."""
    x = _lanes(dev, b, n, d, dtype, seed=b * 31 + n + d)
    g = gram_batched(x)
    want = gram_batched_ref(x)
    _close(g, want)
    for k in range(b):
        _close(g[k], want[k])
        xk = x[k].contiguous()
        diff = (g[k].double() - gram(xk).double()).abs()
        assert bool((diff <= _sum_order_bound(xk)).all())


@pytest.mark.cuda
def test_gram_batched_is_deterministic_and_counts_launches(dev):
    x = _lanes(dev, 6, 17, (1 << 20) + 4, torch.float32, seed=9)
    before = gram_batched.launches
    assert torch.equal(gram_batched(x), gram_batched(x))
    assert gram_batched.launches == before + 2


def _lane_fs(dev, b, n):
    """Per-lane f: 0, past n/2 (the empty mask), the largest valid f, 1,
    n/2, then small values."""
    vals = [0, n // 2 + 1, (n - 1) // 2, 1, n // 2, 2, 3, 4]
    return torch.tensor([vals[k % len(vals)] for k in range(b)],
                        dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(1, 8), (8, 17), (6, 16), (4, 3), (3, 100),
                                 (3, 640)])
@pytest.mark.parametrize("d", [1, 61, 2842])
def test_mixtrim_dyn_matches_plain(dev, dtype, b, n, d):
    """K4: per-lane f (0 .. past n/2), per-lane M, with and without the
    mix, trim and median, the register (n <= 64) and shared-memory sorts."""
    x = _lanes(dev, b, n, d, dtype, seed=b + n + d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    m = torch.softmax(torch.randn((b, n, n), generator=gen, device=dev), -1)
    f = _lane_fs(dev, b, n)
    for mode in ("trim", "med"):
        for mm in (None, m.to(dtype)):
            _close(mixtrim_dyn(x, mm, f, mode), mixtrim_dyn_ref(x, mm, f, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8, 9, 17, 20, 21, 32, 33, 48, 49, 64,
                               100, 640])
def test_mixtrim_dyn_agrees_with_k2_at_equal_f(dev, n):
    """On finite data at equal f: up to 64 workers K2 and K4 run one body
    and must agree bit for bit (the mask's other terms add exact zeros);
    above, within the fp32 tolerance."""
    x = _lanes(dev, 1, n, 4099, torch.float32, seed=n)[0]
    m = torch.softmax(torch.randn((n, n), device=dev), -1)
    for f in range(0, (n - 1) // 2 + 1, max(1, n // 6)):
        ft = torch.tensor(f, dtype=torch.int32, device=dev)
        for mm in (None, m):
            got, want = mixtrim_dyn(x, mm, ft), mixtrim(x, mm, f, "trim")
            if n <= 64:
                assert torch.equal(got, want)
            else:
                _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("n", [17, 16, 100, 640])
def test_mixtrim_dyn_nonfinite_rows_match_plain(dev, fill, n):
    """The rank mask keeps inf * 0 = NaN: a non-finite row makes its
    columns NaN even where its rank is trimmed (as the reference's
    mixtrim_dyn_ref), and the power-of-two pad contributes nothing."""
    b = 4
    x = _lanes(dev, b, n, 1031, torch.float32, seed=n).clone()
    x[1, n - 1] = fill
    x[2, 0, 5:9] = fill
    x[3, :, 7] = fill
    m = torch.softmax(torch.randn((b, n, n), device=dev), -1)
    f = torch.tensor([0, 2, n // 2, 3], dtype=torch.int32, device=dev)
    for mode in ("trim", "med"):
        for mm in (None, m):
            _close(mixtrim_dyn(x, mm, f, mode), mixtrim_dyn_ref(x, mm, f, mode))


@pytest.mark.cuda
def test_mixtrim_dyn_filler_lanes_and_launch_count(dev):
    """A filler lane (f = 0, zero stack, uniform M) gives zeros."""
    x = torch.zeros((3, 17, 2842), device=dev)
    m = torch.full((3, 17, 17), 1.0 / 17, device=dev)
    f = torch.zeros(3, dtype=torch.int32, device=dev)
    before = mixtrim_dyn.launches
    assert torch.equal(mixtrim_dyn(x, m, f), torch.zeros((3, 2842), device=dev))
    assert torch.equal(mixtrim_dyn(x, None, f), torch.zeros((3, 2842), device=dev))
    assert mixtrim_dyn.launches == before + 2


def _lanes_at(dev, b, n, d, dtype, seed, misaligned):
    """A (B, n, D) stack, one element past an aligned address when
    ``misaligned`` (no vector loads, no cp.async staging)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    off = int(misaligned)
    base = torch.randn(b * n * d + off, generator=gen, device=dev).to(dtype)
    return base[off:].view(b, n, d)


#: K4's compiled heights: one per n up to 32, then 48 and 64 (n read at
#: run time above 32).  These n cover both ends of each column-per-thread
#: class (4 up to n = 8, 2 up to 20, 1 above) and of the shared heights.
K4_SMALL_NS = [1, 2, 3, 8, 9, 16, 17, 20, 21, 31, 32, 33, 48, 49, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", K4_SMALL_NS)
@pytest.mark.parametrize("d,misaligned", [(4096, False), (4099, False),
                                          (4098, True), (1, False)])
def test_mixtrim_dyn_every_small_height_matches_plain(dev, dtype, n, d,
                                                      misaligned):
    """K4's n <= 64 body at each kind of height: f from 0 to past n/2 over
    the lanes, with and without the mix, trim and median, aligned and
    misaligned stacks, D a multiple of 4 or not."""
    b = n // 2 + 3
    x = _lanes_at(dev, b, n, d, dtype, seed=n * 7 + d, misaligned=misaligned)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + 1)
    m = torch.softmax(torch.randn((b, n, n), generator=gen, device=dev), -1)
    f = torch.arange(b, dtype=torch.int32, device=dev)
    for mode in ("trim", "med"):
        for mm in (None, m.to(dtype)):
            _close(mixtrim_dyn(x, mm, f, mode), mixtrim_dyn_ref(x, mm, f, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", list(range(1, 65)))
@pytest.mark.parametrize("d,misaligned", [(4096, False), (4099, False),
                                          (4098, True), (61, False)])
def test_mixtrim_every_small_height_matches_plain(dev, dtype, n, d,
                                                  misaligned):
    """K2 on the n <= 64 body it shares with K4, at every n: trim at
    f = 0, 1, 2 and the largest f, and the median, with and without the
    mix; D a multiple of the columns a thread owns or not, fewer columns
    than one block takes, and a stack at a storage offset of one element
    (the scalar load path).  D = 61 and not 1: the tolerance is 1e-5 of
    the largest |plain|, and one trimmed mean of mixed rows can cancel to
    a value far below the rounding of the sums that make it."""
    x = _stack(dev, n, d, dtype, misaligned, seed=n * 13 + d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + 2)
    m = torch.softmax(torch.randn(n, n, generator=gen, device=dev), -1)
    before = mixtrim.launches
    calls = 0
    for mode in ("trim", "med"):
        for f in sorted({0, min(1, (n - 1) // 2), min(2, (n - 1) // 2),
                         (n - 1) // 2}) if mode == "trim" else (0,):
            for mm in (None, m.to(dtype)):
                _close(mixtrim(x, mm, f, mode), mixtrim_ref(x, mm, f, mode))
                calls += 1
    assert mixtrim.launches == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("n", list(range(1, 21)))
def test_mixtrim_sort_is_exact_on_every_0_1_column(dev, n):
    """The 0-1 principle for K2's slice: on every 0-1 column its trim at
    every f and its median equal the plain version exactly.  The plain
    version runs on the CPU, whose mean divides the exact sum once, as
    the kernel does."""
    x = _zero_one(dev, n)
    xc = x.cpu()
    for f in range(0, (n - 1) // 2 + 1):
        assert torch.equal(mixtrim(x, None, f, "trim").cpu(),
                           mixtrim_ref(xc, None, f, "trim"))
    assert torch.equal(mixtrim(x, None, 0, "med").cpu(),
                       mixtrim_ref(xc, None, 0, "med"))


def _zero_one(dev, n):
    """The (n, 2^n) stack holding each 0-1 column once."""
    cols = torch.arange(1 << n, device=dev)
    return ((cols[None, :] >> torch.arange(n, device=dev)[:, None]) & 1).float()


@pytest.mark.cuda
@pytest.mark.parametrize("n", list(range(1, 21)))
def test_mixtrim_dyn_sort_is_exact_on_every_0_1_column(dev, n):
    """The 0-1 principle: a network that sorts every 0-1 vector sorts
    every input.  The (1, n, 2^n) stack holds each 0-1 column once; K4's
    trim at every f and its median equal the plain version exactly."""
    x = _zero_one(dev, n)[None].contiguous()
    for f in range(0, n // 2 + 2):
        ft = torch.tensor([f], dtype=torch.int32, device=dev)
        assert torch.equal(mixtrim_dyn(x, None, ft),
                           mixtrim_dyn_ref(x, None, ft))
    f0 = torch.zeros(1, dtype=torch.int32, device=dev)
    assert torch.equal(mixtrim_dyn(x, None, f0, "med"),
                       mixtrim_dyn_ref(x, None, f0, "med"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 9, 17, 32, 33, 64, 65, 100, 128, 129,
                               256])
@pytest.mark.parametrize("d,misaligned", [(2842, False), (4099, False),
                                          (4098, True),
                                          ((1 << 18) + 8, False)])
def test_gram_batched_every_n_per_lane_and_repeatable(dev, dtype, n, d,
                                                      misaligned):
    """K5 on both of its paths (staged for n <= 32, the tiled product
    above, every tile height): each lane within 1e-5 of its own max |G| of
    the plain version, two runs equal bit for bit, each lane exactly
    symmetric."""
    b = 3
    x = _lanes_at(dev, b, n, d, dtype, seed=n + d, misaligned=misaligned)
    g = gram_batched(x)
    want = gram_batched_ref(x)
    for k in range(b):
        _close(g[k], want[k])
    assert torch.equal(g, gram_batched(x))
    assert torch.equal(g, g.mT)


# --- the lane forms: each lane bit for bit the single-lane kernel ----------

def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _lane_stack(dev, dtype, b, n, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, n, d), generator=g, device=dev)
    x[1 % b, n - 1, 3:40] = float("inf")
    x[2 % b, 0, 50:90] = float("nan")
    perms = torch.stack([torch.randperm(n, generator=torch.Generator()
                                        .manual_seed(seed + k))
                         for k in range(b)]).to(dev)
    return x.to(dtype), perms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s", [(17, 3), (17, 2), (16, 2), (40, 4),
                                 (9, 9)])
@pytest.mark.parametrize("d", [4096, 4099])
def test_bucketgram_lanes_equal_single_lane_per_lane(dev, dtype, n, s, d):
    b = 3
    x, perms = _lane_stack(dev, dtype, b, n, d, n + s)
    assign = torch.div(torch.argsort(perms, dim=1), s, rounding_mode="floor")
    nb = -(-n // s)
    y, g = bucketgram_lanes(x, assign, nb)
    ym = bucketmeans_lanes(x, assign, nb)
    wy, wg = bucket_means_gram_lanes_ref(x, assign, nb)
    _close_means(y, wy)
    assert torch.equal(_bits(ym), _bits(y))
    for k in range(b):
        y1, g1 = bucketgram(x[k], assign[k], nb)
        assert torch.equal(_bits(y[k]), _bits(y1))
        if nb <= 8:
            assert torch.equal(_bits(g[k]), _bits(g1))
        _close(g[k], wg[k])
    assert not bool(torch.isnan(y[0, :, :3]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 5, 9, 17, 33, 64, 65, 200])
@pytest.mark.parametrize("d", [2841, 2842, 2844, 4099])
@pytest.mark.parametrize("b", [1, 4, 5, 13])
@pytest.mark.parametrize("misaligned", [False, True])
def test_combine_and_median_lanes_equal_single_lane_per_lane(dev, dtype, n,
                                                             d, b, misaligned):
    """The launch-sized stacks the fleet gives K3 (the grid's 5 lanes of
    17 or 9 workers at D = 2842): D a multiple of 4, of 2 or of neither
    (each of K3's load widths), a base one element past an aligned address
    (1-element loads), inf and NaN rows; the lane forms within 1e-5 of
    their plain versions with the non-finite positions exact, and each
    lane bit for bit the single-lane kernel on that lane."""
    x, _ = _lane_stack(dev, dtype, b, n, d, n)
    if misaligned:
        base = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        base[1:].copy_(x.reshape(-1))
        x = base[1:].view(b, n, d)
    g = torch.Generator(device=dev).manual_seed(n)
    c = torch.softmax(torch.randn((b, n), generator=g, device=dev), -1)
    m = torch.softmax(torch.randn((b, n, n), generator=g, device=dev), -1)
    r = combine_lanes(x, c)
    _close(r, combine_lanes_ref(x, c))
    for mm in (m, None):
        med = mixtrim_lanes(x, mm)
        _close(med, mixtrim_lanes_ref(x, mm))
        for k in range(b):
            want = mixtrim(x[k], None if mm is None else mm[k], 0, "med")
            assert torch.equal(_bits(med[k]), _bits(want))
    for k in range(b):
        assert torch.equal(_bits(r[k]), _bits(combine(x[k], c[k])))


@pytest.mark.cuda
def test_combine_argument_checks_keep_their_errors(dev):
    """The lean host path refuses what the kernel does not take with the
    errors the wrappers always raised, and counts no launch for it."""
    x = torch.randn((5, 17, 2842), device=dev)
    c = torch.softmax(torch.randn((5, 17), device=dev), -1)
    before = (combine.launches, combine_lanes.launches)
    cases = [
        (lambda: combine_lanes(x.transpose(1, 2).contiguous().transpose(1, 2),
                               c), ValueError, "must be contiguous"),
        (lambda: combine_lanes(torch.randn((5, 17, 5684), device=dev)[..., ::2],
                               c), ValueError, "must be contiguous"),
        (lambda: combine_lanes(x.half(), c), TypeError, "float32 or bfloat16"),
        (lambda: combine_lanes(x.double(), c), TypeError, "float32 or bfloat16"),
        (lambda: combine_lanes(x[:, :0], c[:, :0]), ValueError, "empty stack"),
        (lambda: combine_lanes(x[0], c), ValueError, r"\(B, n, D\) stack"),
        (lambda: combine_lanes(x[:0], c[:0]), ValueError, "1 <= B <= 65535"),
        (lambda: combine_lanes(x, c[:, :16].contiguous()), ValueError,
         r"combine coeff: expected shape \(5, 17\), got \(5, 16\)"),
        (lambda: combine_lanes(x, c.double()), ValueError,
         "contiguous float32 tensor"),
        (lambda: combine_lanes(x, c.cpu()), ValueError,
         "contiguous float32 tensor"),
        (lambda: combine_lanes(x, c.T.contiguous().T), ValueError,
         "contiguous float32 tensor"),
        (lambda: combine(x[0], c[0, :16].contiguous()), ValueError,
         r"combine coeff: expected shape \(1, 17\), got \(1, 16\)"),
        (lambda: combine(x[0].half(), c[0]), TypeError, "float32 or bfloat16"),
        (lambda: combine(x[0, :, ::2], c[0]), ValueError, "must be contiguous"),
    ]
    for call, err, match in cases:
        with pytest.raises(err, match=match):
            call()
    assert (combine.launches, combine_lanes.launches) == before


# --- the fleet's routes: the permutation route, no synchronizing call -----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s", [(17, 3), (17, 2), (16, 2), (17, 1),
                                 (17, 17), (40, 4), (9, 9), (33, 5), (5, 2),
                                 (40, 2)])
@pytest.mark.parametrize("d,misaligned", [(2842, False), (2844, False),
                                          (4096, False), (4099, False),
                                          (4096, True), ((1 << 18) + 8, False)])
def test_bucketgram_perm_route_equals_id_route_and_single_lane(
        dev, dtype, n, s, d, misaligned):
    """K6 / K7's lane form from each lane's permutation (the plan built by
    the kernel) against the id route (the plan built on the host) and the
    single-lane kernel: means bit for bit (bf16 within one ulp of the
    plain version), the register Gram bit for bit up to 8 buckets, K5's on
    the means above; inf / NaN rows spread in their lane; every load width
    (D a multiple of 8, 4, 2 or neither, a base one element off); two runs
    bit for bit."""
    b = 5
    x, perms = _lane_stack(dev, dtype, b, n, d, 7 * n + s)
    if misaligned:
        base = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        base[1:].copy_(x.reshape(-1))
        x = base[1:].view(b, n, d)
    assign, nb = perm_assignment(perms, s), -(-n // s)
    before = (bucketgram_lanes.launches, bucketmeans_lanes.launches)
    y, g = bucketgram_lanes_perms(x, perms, s)
    ym = bucketmeans_lanes_perms(x, perms, s)
    assert (bucketgram_lanes.launches, bucketmeans_lanes.launches) == (
        before[0] + 1, before[1] + 1)
    yi, gi = bucketgram_lanes(x, assign, nb)
    assert torch.equal(_bits(y), _bits(yi)) and torch.equal(_bits(ym), _bits(y))
    assert torch.equal(_bits(g), _bits(gi))
    wy, wg = bucket_means_gram_lanes_ref(x, assign, nb)
    _close_means(y, wy)
    for k in range(b):
        _close(g[k], wg[k])
        y1, g1 = bucketgram(x[k], assign[k], nb)
        assert torch.equal(_bits(y[k]), _bits(y1))
        if nb <= 8:
            assert torch.equal(_bits(g[k]), _bits(g1))
    y2, g2 = bucketgram_lanes_perms(x, perms, s)
    assert torch.equal(_bits(y2), _bits(y)) and torch.equal(_bits(g2), _bits(g))
    assert not bool(torch.isnan(y[0, :, :3]).any())


@pytest.mark.cuda
def test_bucketgram_perm_route_argument_checks(dev):
    x = torch.randn((5, 17, 2842), device=dev)
    perms = torch.stack([torch.randperm(17) for _ in range(5)]).to(dev)
    cases = [
        (lambda: bucketgram_lanes_perms(x, perms.cpu(), 3),
         "contiguous int64 tensor on cuda"),
        (lambda: bucketgram_lanes_perms(x, perms.int(), 3),
         "contiguous int64 tensor"),
        (lambda: bucketmeans_lanes_perms(x, perms[:4], 2),
         r"perms must have shape \(5, 17\), got \(4, 17\)"),
        (lambda: bucketmeans_lanes_perms(x, perms, 0),
         "1 <= bucket_size <= 17"),
        (lambda: bucketmeans_lanes_perms(x.half(), perms, 2),
         "float32 or bfloat16"),
    ]
    before = (bucketgram_lanes.launches, bucketmeans_lanes.launches)
    for call, match in cases:
        with pytest.raises((ValueError, TypeError), match=match):
            call()
    assert (bucketgram_lanes.launches, bucketmeans_lanes.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fleet_routes_make_no_synchronizing_call(dev, dtype):
    """The median lanes, K4 and K6 / K7's permutation route at the grid's
    (5, 17, 2842), with and without the mix and K5 above 8 means, under
    torch.cuda.set_sync_debug_mode("error"): none waits for the card."""
    x = torch.randn((5, 17, 2842), device=dev).to(dtype)
    perms = torch.stack([torch.randperm(17) for _ in range(5)]).to(dev)
    m = torch.softmax(torch.randn((5, 17, 17), device=dev), -1)
    f = torch.full((5,), 4, dtype=torch.int32, device=dev)
    calls = [lambda: mixtrim_lanes(x, m), lambda: mixtrim_lanes(x, None),
             lambda: mixtrim_dyn(x, m, f), lambda: mixtrim_dyn(x, None, f),
             lambda: bucketgram_lanes_perms(x, perms, 3),
             lambda: bucketmeans_lanes_perms(x, perms, 2),
             lambda: bucketgram_lanes_perms(x, perms, 2)]
    for call in calls:                  # the build and the plans first
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 1100])
def test_median_lanes_above_64_workers_pass_no_f(dev, n):
    """Above 64 workers the median lanes reach the tiled-mix select and the
    shared-memory sort with no f: each lane equals K2's median on it bit
    for bit, with and without the mix."""
    b, d = 3, 61
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((b, n, d), generator=g, device=dev)
    m = torch.softmax(torch.randn((b, n, n), generator=g, device=dev), -1)
    for mm in (m, None):
        med = mixtrim_lanes(x, mm)
        _close(med, mixtrim_lanes_ref(x, mm))
        for k in range(b):
            want = mixtrim(x[k], None if mm is None else mm[k], 0, "med")
            assert torch.equal(_bits(med[k]), _bits(want))


@pytest.mark.cuda
def test_bucketgram_limits_agree_with_the_library(dev):
    """The wrapper picks K6 / K7's path by limits the kernel also checks:
    the register Gram's buckets, the register path's means and workers."""
    lib = _build.library()
    assert lib.repro_bucketgram_reg_nb() == bucketgram_ops.REG_NB
    assert lib.repro_bucketgram_means_nb() == bucketgram_ops.MEANS_NB
    assert lib.repro_bucketgram_reg_max_n() == bucketgram_ops.REG_MAX_N
