"""The launch plans of K4 / K2's median lanes and of K6 / K7, on the CPU.

The fleet launches these kernels on launch-sized stacks, where a call
costs its host path: each wrapper fills a ctypes plan per shape (cached)
and the kernel builds what it can on the device.  Held here, without a
card:
* the geometry (``_common.launch_geometry`` for K3, the n <= 64 mixtrim
  body and K6 / K7's register path; ``bucketgram.ops.plan_geometry``):
  every (D, load width, SM count) case covers each column once, with the
  block sizes and counts the kernels take;
* the plan of K6 / K7's permutation route (``perm_plan_ref``, the plain
  version of the kernel's ``stage_plan``) against the construction from
  bucket ids the wrappers use (``plan_arrays``: argsort / searchsorted),
  for random permutations, every s from 1 to n, a ragged tail;
* the host paths with the C entries recorded: the median lanes pass no f,
  K4 its f, a fp32 contiguous M is passed as it is, the permutation route
  hands over the permutations, the id route writes its plan where the
  kernel reads it;
* ``_hier_reduce_lanes`` (the permutation route on the kernel backend,
  which runs the plain versions on CPU tensors, and the torch backend)
  against the reference's vmapped ``bucket_means_gram`` (Pallas in
  interpret mode) at a small size, and the permutation-route wrappers
  against the id-route ones bit for bit;
* the median lanes' and K4's CPU paths against the reference's vmapped
  ``mixtrim`` / ``mixtrim_dyn``.

Tolerances: 1e-5 of the largest |reference| (fp32 sums in another order);
bf16 bucket means one bf16 ulp on top (a rounding boundary between the
two packages' fp32 sums); NaN positions exact.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bucketing import bucket_matrix as j_bucket_matrix
from repro.kernels.bucketgram import bucket_means_gram as j_bucket_means_gram
from repro.kernels.mixtrim import mixtrim as j_mixtrim
from repro.kernels.mixtrim import mixtrim_dyn as j_mixtrim_dyn
from repro_torch.core import robust as trobust
from repro_torch.core.types import AggregatorSpec
from repro_torch.kernels import _build, _common
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.bucketgram import ops as bg_ops
from repro_torch.kernels.bucketgram import (
    bucketgram_lanes, bucketgram_lanes_perms, bucketmeans_lanes,
    bucketmeans_lanes_perms, perm_assignment, perm_plan_ref, plan_arrays,
)
from repro_torch.kernels.mixtrim import mixtrim_dyn, mixtrim_lanes
from repro_torch.kernels.mixtrim import ops as mt_ops

torch.set_num_threads(2)

RTOL = 1e-5
GEOMETRY_DS = (1, 3, 7, 31, 32, 33, 127, 1000, 2841, 2842, 2844, 4096,
               4099, 8192, (1 << 18) + 3, 1 << 20, (1 << 24) + 3, 1 << 24,
               361_821_120)
SMS = (132, 114, 1)


def _visits(units: int, threads: int, blocks: int) -> np.ndarray:
    """How often the grid-stride loop of blocks x threads visits each of
    ``units`` units (computed only up to 2^20 units)."""
    stride = threads * blocks
    starts = np.arange(min(stride, units))
    trips = -(-(units - starts) // stride)
    visits = np.zeros(units, np.int64)
    for k in range(int(trips.max())):
        visits[starts[trips > k] + k * stride] += 1
    return visits


def _check_geometry(d: int, width: int, threads: int, blocks: int,
                    sms: int, max_threads: int) -> None:
    assert threads % 32 == 0 and 32 <= threads <= max_threads
    assert threads & (threads - 1) == 0
    assert 1 <= blocks <= 16 * sms
    units = -(-d // width)
    if units <= 1 << 20:
        assert (_visits(units, threads, blocks) == 1).all()
        cols = np.concatenate([np.arange(u * width, min(u * width + width, d))
                               for u in range(min(units, 4096))])
        np.testing.assert_array_equal(cols, np.arange(min(d, 4096 * width)))
    if units >= max_threads * sms:       # a large lane keeps the full block
        assert threads == max_threads
    if units <= 32 * 16 * sms:           # a small lane: one unit a thread
        assert threads * blocks >= units


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("d", GEOMETRY_DS)
def test_median_lanes_and_k4_geometry_covers_every_column(d, sms):
    """The n <= 64 mixtrim body at every column count a thread owns (4 to
    8 workers, 2 to 20, else 1), blocks of 32..128 threads; a ragged last
    unit (D not a multiple) is one thread's too."""
    for n in (3, 8, 9, 17, 20, 21, 33, 64):
        cols = mt_ops.cols_per_thread(n)
        threads, blocks = _common.launch_geometry(d, cols, sms, 128)
        _check_geometry(d, cols, threads, blocks, sms, 128)
    # The grid's (5, 17, 2842): 45 blocks of 32 a lane, not 12 of 128.
    assert _common.launch_geometry(2842, 2, 132, 128) == (32, 45)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("d", GEOMETRY_DS)
def test_bucketgram_register_geometry_covers_every_column(d, sms):
    """K6 / K7's register path at every load width dividing D (8 bf16
    columns, 4, 2, 1), blocks of 32..256 threads (..128 with the register
    Gram); above REG_NB buckets with the Gram and MEANS_NB without, or
    above REG_MAX_N workers, a thread per (bucket, four columns)."""
    for vec in (8, 4, 2, 1):
        if d % vec:
            continue
        for nb, gram in ((6, True), (8, True), (9, False), (16, False)):
            top = 128 if gram else 256
            reg, threads, blocks = bg_ops.plan_geometry(d, 17, nb, gram, vec,
                                                        sms)
            assert reg
            assert (threads, blocks) == _common.launch_geometry(d, vec, sms,
                                                                top)
            _check_geometry(d, vec, threads, blocks, sms, top)
    reg, threads, blocks = bg_ops.plan_geometry(d, 17, 9, True, 4, sms)
    assert not reg and threads == 256
    assert blocks == max(1, min(-(-(-(-d // 4) * 9) // 256), 16 * sms))
    assert not bg_ops.plan_geometry(d, 17, 17, False, 4, sms)[0]
    assert not bg_ops.plan_geometry(d, 4097, 8, True, 4, sms)[0]
    assert bg_ops.plan_geometry(d, 4096, 8, True, 4, sms)[0]


def test_bucketgram_load_width_is_the_widest_every_row_allows():
    lw = bg_ops.load_width
    assert lw(0, 0, None, 2842, 4) == 2      # the grid's D, fp32: 8 bytes
    assert lw(0, 0, None, 2842, 2) == 2      # ... bf16: 4 bytes
    assert lw(0, 0, None, 2844, 2) == 4
    assert lw(0, 0, None, 1 << 24, 2) == 8   # 16-byte bf16 loads
    assert lw(0, 0, None, 1 << 24, 4) == 4
    assert lw(8, 0, None, 1 << 24, 2) == 4   # a base 8 bytes past 16
    assert lw(0, 8, None, 1 << 24, 2) == 4   # the means' base bounds it
    assert lw(0, 0, 8, 1 << 24, 2) == 2      # ... and the fp32 means'
    assert lw(2, 0, None, 4096, 2) == 1
    assert lw(4, 0, None, 4096, 4) == 1
    for d in GEOMETRY_DS:
        for item in (2, 4):
            for off in range(0, 16, item):
                vec = lw(off, 0, None, d, item)
                assert d % vec == 0 and off % (vec * item) == 0
                assert vec * item <= 16


# --- the permutation route's plan ------------------------------------------

def _perms(b: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.permutation(n)
                                      for _ in range(b)]).astype(np.int64))


PLAN_CASES = [(n, s) for n in (1, 2, 5, 9, 16, 17) for s in range(1, n + 1)] \
    + [(33, s) for s in (1, 2, 4, 7, 16, 32, 33)]


@pytest.mark.parametrize("n,s", PLAN_CASES)
def test_perm_plan_equals_the_id_construction(n, s):
    """stage_plan's plain version against plan_arrays on the ids the
    permutation gives (worker i in bucket argsort(perm)[i] // s, weights
    1/|bucket| as bincount forms them): order, starts and weights equal,
    the ragged tail's weight included."""
    b = 4
    perms = _perms(b, n, 100 * n + s)
    assign = perm_assignment(perms, s)
    nb = -(-n // s)
    _, weight = bg_ops._resolve_lanes(torch.zeros((b, n, 1)), assign, nb)
    want = plan_arrays(assign, weight, nb)
    got = perm_plan_ref(perms, s)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    order, start, wt = got
    assert start[:, -1].eq(n).all() and start[:, 0].eq(0).all()
    tail = n - (nb - 1) * s
    assert torch.equal(wt[:, -1], torch.full((b,), 1.0 / tail))


# --- the host paths with the C entries recorded ----------------------------

class _FakeLib:
    """Records the C entries' arguments (and the plans' fields) instead of
    launching."""

    def __init__(self):
        self.calls = []

    def repro_mixtrim_dyn(self, x, m, mt, f, out, plan, stream):
        p = mt_ops.DynPlan.from_address(plan)
        self.calls.append(dict(x=x, m=m, mt=mt, f=f, out=out, stream=stream,
                               **{k: getattr(p, k) for k, _ in p._fields_}))
        return 0

    def repro_mixtrim_select_scratch(self, n):
        return 0

    def repro_bucketgram_scratch(self, plan):
        p = bg_ops.Plan.from_address(plan)
        words = p.lanes * (2 * p.n + p.nb + 1) if p.s == 0 else 0
        if p.gram:
            words += p.lanes * p.blocks * 36
        elif not p.reg:
            words += p.lanes * p.d
        return words

    def repro_bucketgram(self, x, perm, scratch, y, yf, g, plan, stream):
        p = bg_ops.Plan.from_address(plan)
        self.calls.append(dict(x=x, perm=perm, scratch=scratch, y=y, yf=yf,
                               g=g, stream=stream,
                               **{k: getattr(p, k) for k, _ in p._fields_}))
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    mt_ops._dyn_plan.cache_clear()
    bg_ops._plan.cache_clear()
    mt_ops._scratch_words.cache_clear()
    monkeypatch.setattr(_build, "_LIB", lib)
    monkeypatch.setitem(_build._SM_COUNT, -1, 132)
    for mod in (mt_ops, bg_ops):
        monkeypatch.setattr(mod, "device_guard", lambda x: _common._NO_GUARD)
        monkeypatch.setattr(mod, "stream_of", lambda x: 4242)
    yield lib
    mt_ops._dyn_plan.cache_clear()
    bg_ops._plan.cache_clear()
    mt_ops._scratch_words.cache_clear()


@pytest.mark.parametrize("b,n,d", [(5, 17, 2842), (8, 17, 1 << 20),
                                   (5, 9, 2842), (3, 8, 4099),
                                   (2, 40, 1000), (3, 100, 61)])
def test_median_lanes_and_k4_host_path(fake, b, n, d):
    """The median lanes pass no f and the median flag; K4 passes its f; the
    plan holds the geometry (n <= 64: launch_geometry with blocks of up to
    128; above, 16 blocks an SM over the lanes) and the SM count; a fp32
    contiguous M goes as it is, a bf16 one as its fp32 copy."""
    x = torch.zeros((b, n, d))
    m = torch.zeros((b, n, n))
    f = torch.full((b,), 2, dtype=torch.int32)
    out = mt_ops._launch_lanes(x, m, None, True, "mixtrim_lanes")
    assert out.shape == (b, d) and out.dtype == torch.float32
    med = fake.calls[-1]
    assert med["f"] is None and med["med"] == 1 and med["m"] == m.data_ptr()
    assert (med["x"], med["stream"], med["sms"]) == (x.data_ptr(), 4242, 132)
    assert (med["d"], med["lanes"], med["n"], med["dtype"]) == (d, b, n, 0)
    if n <= 64:
        want = _common.launch_geometry(d, mt_ops.cols_per_thread(n), 132, 128)
    else:
        want = (128, max(1, 16 * 132 // b))
    assert (med["threads"], med["blocks"]) == want
    mt_ops._launch_lanes(x.bfloat16(), m.bfloat16(), f, False, "mixtrim_dyn")
    k4 = fake.calls[-1]
    assert k4["f"] == f.data_ptr() and k4["med"] == 0 and k4["dtype"] == 1
    assert k4["m"] not in (None, m.data_ptr())
    mt_ops._launch_lanes(x, None, f, False, "mixtrim_dyn")
    assert fake.calls[-1]["m"] is None and fake.calls[-1]["mt"] is None
    assert len(fake.calls) == 3


@pytest.mark.parametrize("n,s", [(17, 3), (17, 2), (16, 2), (17, 1),
                                 (40, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucketgram_host_paths(fake, monkeypatch, n, s, dtype):
    """The permutation route hands the register path the permutations and
    s and writes nothing into the scratch (none without the Gram: the
    register path plans in shared memory); off it (above MEANS_NB means)
    it hands over perm_plan_ref's arrays; the id route writes plan_arrays
    at the head of the scratch (order, starts, weights as int32 words)
    with s = 0.  Both take the register Gram up to 8 buckets (no yf), fp32 means
    for K5 above with a bf16 stack, and a lane count that does not enter
    the geometry."""
    b, d = 5, 2842
    nb = -(-n // s)
    x = torch.zeros((b, n, d), dtype=dtype)
    perms = _perms(b, n, 7)
    y, g = bg_ops._run(x, nb, s, perms, None, True, lambda ym: "folded")
    call = fake.calls[-1]
    if call["reg"]:
        assert call["perm"] == perms.data_ptr() and call["s"] == s
        assert (call["scratch"] is None) == (not call["gram"])
    else:                               # perm_plan_ref's arrays handed over
        assert call["perm"] is None and call["s"] == 0
        assert call["scratch"] is not None
    assert (call["lanes"], call["n"], call["nb"], call["d"]) == (b, n, nb, d)
    assert y.shape == (b, nb, d) and y.dtype == dtype
    if nb <= 8:
        assert call["gram"] == 1 and call["reg"] == 1 and call["yf"] is None
        assert g.shape == (b, nb, nb) and call["g"] == g.data_ptr()
    else:
        assert g == "folded" and call["gram"] == 0 and call["g"] is None
        assert (call["yf"] is None) == (dtype == torch.float32)
        assert call["reg"] == int(nb <= 16)
    # One lane of the same D takes the same load width and geometry.
    geometry = (call["vec"], call["threads"], call["blocks"])
    bg_ops._run(x[:1].clone(), nb, s, perms[:1].clone(), None, True,
                lambda ym: "folded")
    assert (fake.calls[-1]["vec"], fake.calls[-1]["threads"],
            fake.calls[-1]["blocks"]) == geometry
    # The id route: its plan is written where the kernel reads it.
    assign = perm_assignment(perms, s)
    _, weight = bg_ops._resolve_lanes(x, assign, nb)
    seen = {}

    def capture(x_, nb_, s_, perms_, fill, with_gram, fold):
        seen.update(s=s_, perms=perms_, fill=fill)
        return None, None

    monkeypatch.setattr(bg_ops, "_run", capture)
    bg_ops._launch_ids(x, assign, weight, nb, with_gram=False)
    assert seen["s"] == 0 and seen["perms"] is None
    scratch = torch.full((b * (2 * n + nb + 1),), -7, dtype=torch.int32)
    seen["fill"](scratch)
    order, start, w = plan_arrays(assign, weight, nb)
    o, st = order.numel(), start.numel()
    assert torch.equal(scratch[:o], order.reshape(-1))
    assert torch.equal(scratch[o:o + st], start.reshape(-1))
    assert torch.equal(scratch[o + st:].view(torch.float32), w.reshape(-1))


def test_perm_route_refuses_what_the_kernel_does_not_take(fake, monkeypatch):
    """The permutation route's own checks (the stack's are check_lanes',
    stubbed here: it refuses a CPU stack), before any launch."""
    monkeypatch.setattr(bg_ops, "check_lanes", lambda x, what: None)
    x = torch.zeros((5, 17, 2842))
    perms = _perms(5, 17, 1)
    cases = [
        (lambda: bg_ops._check_perms(x, perms[:, :16], 3, "k"),
         r"perms must have shape \(5, 17\), got \(5, 16\)"),
        (lambda: bg_ops._check_perms(x, perms.int(), 3, "k"),
         "contiguous int64 tensor"),
        (lambda: bg_ops._check_perms(x, perms.T.contiguous().T, 3, "k"),
         "contiguous int64 tensor"),
        (lambda: bg_ops._check_perms(x, perms, 0, "k"),
         "1 <= bucket_size <= 17"),
        (lambda: bg_ops._check_perms(x, perms, 18, "k"),
         "1 <= bucket_size <= 17"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    assert bg_ops._check_perms(x, perms, 3, "k") == 6
    assert not fake.calls


# --- the permutation route against the reference ---------------------------

N, D = 17, 64


def _keys_perms(b: int, seed: int):
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return keys, np.stack([np.asarray(jax.random.permutation(k, N))
                           for k in keys]).astype(np.int64)


def _close(got, want, bf16: bool = False):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    tol = RTOL * float(np.abs(want[fin]).max())
    slack = 2.0 ** -7 * np.abs(want[fin]) if bf16 else 0.0
    assert (np.abs(got[fin] - want[fin]) <= tol + slack).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 3, 5, 17])
@pytest.mark.parametrize("rule,pre", [("cwtm", "nnm"), ("cwtm", None)])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_hier_reduce_lanes_matches_the_reference(backend, rule, pre, s,
                                                 dtype):
    """The lanes' hierarchical pre-reduction from each lane's permutation:
    means (and with NNM their Gram) against the reference's
    ``vmap(bucket_means_gram)`` over each lane's ``bucket_matrix`` (Pallas
    in interpret mode); the kernel backend runs the permutation route's
    plain versions on CPU tensors, the torch backend the dense plain
    version; both bit for bit the same."""
    b = 3
    keys, perms = _keys_perms(b, 31 * s)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(b, N, D)).astype(np.float32)
    x[:, N - 3:] += 4.0
    jx = jnp.asarray(x).astype(dtype)
    bmats = jax.vmap(lambda k: j_bucket_matrix(k, N, s))(keys)
    with_gram = pre == "nnm"
    jy, jg = jax.vmap(lambda xx, bm: j_bucket_means_gram(
        xx, bm, with_gram=with_gram, interpret=True))(jx, bmats)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    spec = AggregatorSpec(rule=rule, pre=pre, hier=True, bucket_size=s)
    f = torch.tensor([0, 1, 4])
    outs = {}
    for be in (backend, "torch" if backend == "cuda" else "cuda"):
        kdispatch.open_record(requested=be, backend=be, rule=rule, pre=pre,
                              dyn=True, lanes=b)
        outs[be] = trobust._hier_reduce_lanes(
            tx, spec, f, perms=torch.from_numpy(perms), batched=True,
            backend=be)
        names = [d.primitive for d in kdispatch.last_dispatch().decisions]
        assert names[0] == ("bucketgram_lanes" if with_gram
                            else "bucketmeans_lanes")
    y, fa, g = outs[backend]
    assert y.dtype == tx.dtype and y.shape == (b, -(-N // s), D)
    _close(y, jy.astype(jnp.float32), bf16=dtype == "bfloat16")
    nb = -(-N // s)
    assert torch.equal(fa, torch.clamp(f, max=(nb - 1) // 2))
    if with_gram:
        for k in range(b):
            _close(g[k], jg[k])
    else:
        assert g is None
    y2, _, g2 = outs["torch" if backend == "cuda" else "cuda"]
    assert torch.equal(y.float(), y2.float())
    if with_gram:
        assert torch.equal(g, g2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 9, 17])
def test_perm_route_wrappers_equal_the_id_route(s, dtype):
    """On CPU tensors the permutation-route wrappers run the id route's
    plain version on perm_assignment's ids: bit for bit, inf / NaN rows
    included, and they count no launch."""
    b = 4
    _, perms = _keys_perms(b, s)
    x = torch.from_numpy(np.random.default_rng(s).normal(
        size=(b, N, D)).astype(np.float32))
    x[1, 4, 10:25] = float("inf")
    x[2, 0, 30:40] = float("nan")
    x = x.to(dtype)
    tp = torch.from_numpy(perms)
    assign, nb = perm_assignment(tp, s), -(-N // s)
    before = (bucketgram_lanes.launches, bucketmeans_lanes.launches)
    y, g = bucketgram_lanes_perms(x, tp, s)
    yi, gi = bucketgram_lanes(x, assign, nb)
    ym = bucketmeans_lanes_perms(x, tp, s)
    bits = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16
            else t.view(torch.int32))
    assert torch.equal(bits(y), bits(yi)) and torch.equal(bits(ym), bits(y))
    assert torch.equal(bits(g), bits(gi))
    assert (bucketgram_lanes.launches, bucketmeans_lanes.launches) == before


@pytest.mark.parametrize("n", [8, 9, 17])
@pytest.mark.parametrize("mix", [False, True])
def test_median_lanes_and_k4_cpu_paths_match_the_reference(n, mix):
    """The median lanes and K4 (f per lane) on CPU tensors against the
    reference's vmapped mixtrim(mode="med") and mixtrim_dyn (Pallas in
    interpret mode)."""
    b, d = 3, 61
    rng = np.random.default_rng(n + 10 * mix)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    m = np.asarray(jax.nn.softmax(rng.normal(size=(b, n, n)), -1),
                   np.float32) if mix else None
    f = np.array([0, 1, (n - 1) // 2], np.int32)
    jm = jnp.asarray(m) if mix else None
    want_med = jax.vmap(lambda xx, mm: j_mixtrim(
        xx, mm, f=0, mode="med", interpret=True),
        in_axes=(0, 0 if mix else None))(jnp.asarray(x), jm)
    want_k4 = jax.vmap(lambda xx, mm, ff: j_mixtrim_dyn(
        xx, mm, ff, interpret=True),
        in_axes=(0, 0 if mix else None, 0))(jnp.asarray(x), jm,
                                            jnp.asarray(f))
    tm = torch.from_numpy(m) if mix else None
    _close(mixtrim_lanes(torch.from_numpy(x), tm), want_med)
    _close(mixtrim_dyn(torch.from_numpy(x), tm, torch.from_numpy(f)),
           want_k4)


def test_plans_are_filled_once_per_shape(fake):
    """A second call at the same shape reuses the plan (the same address
    goes to the entry) and asks the library nothing more."""
    x = torch.zeros((5, 17, 2842))
    m = torch.zeros((5, 17, 17))
    mt_ops._launch_lanes(x, m, None, True, "mixtrim_lanes")
    mt_ops._launch_lanes(x, m, None, True, "mixtrim_lanes")
    assert mt_ops._dyn_plan.cache_info().hits == 1
    perms = _perms(5, 17, 3)
    bg_ops._run(x, 6, 3, perms, None, True, None)
    bg_ops._run(x, 6, 3, perms, None, True, None)
    assert bg_ops._plan.cache_info().hits == 1
    assert isinstance(mt_ops._dyn_plan(2842, torch.float32, 5, 17, True,
                                       -1)[0], ctypes.Structure)


def test_perm_route_above_perm_max_s_hands_over_the_plan(fake):
    """Above PERM_MAX_S a worker's rank in its bucket would cost s reads in
    every block: the route writes perm_plan_ref's arrays (made on the
    device, read by nothing on the host) and launches as the id route."""
    b, n, s, d = 3, 130, 65, 2842
    x = torch.zeros((b, n, d))
    perms = _perms(b, n, 11)
    bg_ops._run(x, 2, s, perms, None, True, None)
    call = fake.calls[-1]
    assert call["perm"] is None and call["s"] == 0 and call["gram"] == 1
    assert s > bg_ops.PERM_MAX_S and call["scratch"] is not None
