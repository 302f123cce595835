"""The CUDA kernels K1-K3 against their plain versions, on the card.

Every test here is marked ``cuda`` and skips with a reason without a GPU
(the kernels have no CPU mode).  The file imports no JAX, so it runs on a
GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the largest finite |plain| (fp32 sums in another
order); NaN positions and infinities must agree exactly.
"""
import pytest
import torch

from repro_torch.kernels import (
    combine, combine_ref, gram, gram_ref, mixtrim, mixtrim_ref,
)

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
@pytest.mark.parametrize("n", [1, 3, 8, 9, 17, 64])
@pytest.mark.parametrize("d", [1, 7, 1000, (1 << 20) + 3])
@pytest.mark.parametrize("misaligned", [False, True])
def test_kernels_match_plain_versions(dev, dtype, n, d, misaligned):
    """Vector and scalar paths (d % 4, misaligned base), every sort height
    (n = 1 .. 64), diagonal and off-diagonal Gram tiles (n > 8)."""
    x = _stack(dev, n, d, dtype, misaligned, seed=n * 7919 + d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    c = torch.rand(n, generator=gen, device=dev)
    m = torch.softmax(torch.randn(n, n, generator=gen, device=dev), -1)
    _close(gram(x), gram_ref(x))
    _close(combine(x, c), combine_ref(x, c))
    for mode in ("trim", "med"):
        for f in sorted({0, min(2, (n - 1) // 2), (n - 1) // 2}):
            for mm in (None, m.to(dtype)):
                _close(mixtrim(x, mm, f, mode), mixtrim_ref(x, mm, f, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("n,f", [(8, 2), (17, 8)])
def test_mixtrim_nonfinite_rows_match_plain(dev, fill, n, f):
    """nan / inf attack rows: the kernel ranks NaN last, as torch.sort."""
    x = _stack(dev, n, 4099, torch.float32, False, seed=1).clone()
    x[n - f:] = fill
    m = torch.softmax(torch.randn(n, n, device=dev), -1)
    for mode in ("trim", "med"):
        for mm in (None, m):
            _close(mixtrim(x, mm, f, mode), mixtrim_ref(x, mm, f, mode))


@pytest.mark.cuda
def test_gram_is_deterministic_and_counts_launches(dev):
    x = _stack(dev, 8, (1 << 22) + 4, torch.float32, False, seed=2)
    before = gram.launches
    assert torch.equal(gram(x), gram(x))
    assert gram.launches == before + 2


@pytest.mark.cuda
def test_mixtrim_refuses_more_than_64_workers(dev):
    x = _stack(dev, 65, 16, torch.float32, False, seed=3)
    with pytest.raises(ValueError, match="n <= 64"):
        mixtrim(x, None, 2, "trim")
