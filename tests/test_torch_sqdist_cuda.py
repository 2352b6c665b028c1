"""The CUDA sqdist kernels against their plain versions, on the card.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_sqdist_cuda.py

Tolerance: both sides are expansion forms summed in different orders
(``sqdist.cu`` in one f32 FMA chain per entry, ``sqdist_sm90.cu`` in
3xTF32 on the tensor cores, the plain version through a library
product), so |kernel - plain| <= 1e-5 * (|x_i|^2 + |x_j|^2).  The split
pass equals ``tf32_split_plain`` bitwise (hi and lo) and its norms within
1e-6 relative.
"""

import numpy as np
import pytest
import torch

from tdax_torch.ops import sqdist

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from tdax_torch.runtime import get_device
    return get_device()


def _assert_close(got, x):
    want = sqdist.pairwise_sq_euclidean_plain(x)
    sq = (x.double() ** 2).sum(1)
    tol = 1e-5 * (sq[:, None] + sq[None, :])
    assert got.shape == want.shape and got.dtype == torch.float32
    assert ((got.double() - want.double()).abs() <= tol).all()
    assert (got >= 0).all()


@pytest.mark.parametrize("n,d", [(1, 1), (36, 3), (100, 17), (130, 257), (129, 4096),
                                 (257, 1001), (300, 64)])
def test_kernel_matches_plain(device, n, d):
    x = torch.randn((n, d), generator=torch.Generator(device=device).manual_seed(n + d),
                    device=device)
    before = sqdist.LAUNCHES
    got = sqdist.sqdist(x)
    assert sqdist.LAUNCHES == before + 1
    _assert_close(got, x)
    assert torch.equal(got, got.T)


def _counts():
    return sqdist.LAUNCHES, sqdist.LAUNCHES_SM90, sqdist.SPLIT_LAUNCHES


# (n, d) the route sends to sqdist_sm90.cu: n and d on and off the 128 x 32 tile
SM90_SHAPES = [(128, 4096), (129, 4096), (1000, 4100), (300, 64), (257, 1000)]


@pytest.mark.parametrize("kernel", ["fma", "sm90"])
@pytest.mark.parametrize("n,d", SM90_SHAPES)
def test_both_kernels_match_plain(device, n, d, kernel):
    x = torch.randn((n, d), generator=torch.Generator(device=device).manual_seed(n * d),
                    device=device)
    assert sqdist._route(x) == "sm90"
    before = _counts()
    got = sqdist.pairwise_sq_euclidean_cuda(x, _kernel=kernel)
    sm90 = int(kernel == "sm90")
    assert _counts() == (before[0] + 1, before[1] + sm90, before[2] + sm90)
    _assert_close(got, x)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("n,d", [(36, 3), (100, 17), (127, 257), (127, 4096)])
def test_the_route_sends_the_rest_to_the_fma_kernel(device, n, d):
    x = torch.randn((n, d), device=device)
    before = _counts()
    got = sqdist.sqdist(x)
    assert _counts() == (before[0] + 1, before[1], before[2])
    _assert_close(got, x)


def test_the_hopper_kernel_is_symmetric_and_repeats_bitwise(device):
    x = torch.randn((700, 2048), generator=torch.Generator(device=device).manual_seed(11),
                    device=device) * 3 + 1
    first = sqdist.pairwise_sq_euclidean_cuda(x, _kernel="sm90")
    second = sqdist.pairwise_sq_euclidean_cuda(x, _kernel="sm90")
    assert torch.equal(first, second)
    assert torch.equal(first, first.T)
    _assert_close(first, x)


def _scale_recipe(n, d=4096):
    """chip_smoke.scale_cloud's recipe (bench_scale.py:36-40) at n points."""
    rng = np.random.default_rng(42)
    z = rng.normal(size=(n, 4))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    proj = rng.normal(size=(4, d)) / np.sqrt(4)
    return (z @ proj + rng.normal(0, 1e-3, (n, d))).astype(np.float32)


def test_the_hopper_kernel_holds_the_bound_on_the_scale_recipe(device):
    """Points of norm ~32 whose distances cancel most of |x_i|^2 + |x_j|^2:
    one tf32 pass (hi.hi^T alone, exact here in f64) misses the bound on
    this cloud, so only the three passes pass."""
    x = torch.as_tensor(_scale_recipe(512), device=device)
    assert sqdist._route(x) == "sm90"
    hi, _, sq = sqdist.tf32_split_plain(x)
    sq64 = (x.double() ** 2).sum(1)
    scale = sq64[:, None] + sq64[None, :]
    one_pass = (sq.double()[:, None] + sq.double()[None, :]
                - 2.0 * hi.double() @ hi.double().T).clamp_min(0.0)
    want = sqdist.pairwise_sq_euclidean_plain(x).double()
    assert ((one_pass - want).abs() / scale).max() > 1e-5
    got = sqdist.pairwise_sq_euclidean_cuda(x)
    _assert_close(got, x)
    assert torch.equal(got, got.T)


def _split_equal(x):
    hi, lo, sq = sqdist.tf32_split_cuda(x)
    p_hi, p_lo, p_sq = sqdist.tf32_split_plain(x)
    assert torch.equal(hi.view(torch.int32), p_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), p_lo.view(torch.int32))
    assert ((sq - p_sq).abs() <= 1e-6 * p_sq.abs()).all()


@pytest.mark.parametrize("n,d", [(129, 4096), (1000, 4100), (3, 8), (257, 1001)])
def test_the_split_kernel_equals_its_plain_version_bitwise(device, n, d):
    x = torch.randn((n, d), generator=torch.Generator(device=device).manual_seed(n + d),
                    device=device) * 10
    before = sqdist.SPLIT_LAUNCHES
    _split_equal(x)
    assert sqdist.SPLIT_LAUNCHES == before + 1


def test_the_split_kernel_rounds_the_bit_table_as_the_plain_version(device):
    """Ties, negatives and a carry into the exponent (the finite rows of
    tests/test_torch_sqdist_route.py's table)."""
    bits = [0x3F800000, 0x3F800FFF, 0x3F801000, 0x3F803000, 0x3F801001, 0xBF801000,
            0xBF800FFF, 0x3FFFF000, 0xBFFFFFFF, 0x00000000, 0x80000000, 0x3F7FF000]
    x = torch.tensor(bits, dtype=torch.int64).to(torch.int32)
    _split_equal(x.view(torch.float32).reshape(1, -1).to(device))


def test_kernel_reads_a_strided_view(device):
    """Rows with a stride larger than d, a base offset off the 16-byte grid."""
    base = torch.randn((90, 70), device=device)
    x = base[3:, 1:66]
    got = sqdist.pairwise_sq_euclidean_cuda(x)
    _assert_close(got, x.contiguous())


@pytest.mark.parametrize("kernel", ["fma", "sm90"])
def test_both_kernels_read_an_aligned_strided_view(device, kernel):
    """Rows 4104 floats apart (a multiple of 4), a 16-byte base."""
    base = torch.randn((300, 4104), device=device)
    x = base[:, 4:4100]
    assert sqdist._route(x) == "sm90"
    got = sqdist.pairwise_sq_euclidean_cuda(x, _kernel=kernel)
    _assert_close(got, x.contiguous())
    assert torch.equal(got, got.T)


def test_the_hopper_kernel_reads_any_layout_as_its_contiguous_copy(device):
    """d = 4095, rows 4097 floats apart, a base one float past a 16-byte
    boundary, n = 1000: routed to sqdist_sm90.cu (one split, one product),
    bitwise the result on the contiguous copy, within the bound; the
    split pass bitwise its plain version, padded to 4096."""
    base = torch.randn(1000 * 4097 + 1, generator=torch.Generator(device=device).manual_seed(9),
                       device=device)
    x = base[1:].view(1000, 4097)[:, :4095]
    assert sqdist._route(x) == "sm90" and x.data_ptr() % 16 != 0
    before = _counts()
    got = sqdist.sqdist(x)
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.equal(got, sqdist.sqdist(x.contiguous()))
    _assert_close(got, x.contiguous())
    _split_equal(x)


def test_euclidean_wrapper_zero_diagonal_and_cdist(device):
    x = torch.randn((200, 48), device=device)
    d = sqdist.euclidean(x)
    assert (torch.diagonal(d) == 0).all()
    ref = torch.cdist(x.double(), x.double())
    sq = (x.double() ** 2).sum(1)
    assert ((d.double() ** 2 - ref ** 2).abs() <= 1e-5 * (sq[:, None] + sq[None, :])).all()


def test_scale_path_launches_once_and_stays_on_the_card(device):
    from tdax_torch.pipeline.scale import distance_matrix, rips_at_scale
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 0.5, (30, 8)),
                        rng.normal(4, 0.5, (30, 8))]).astype(np.float32)
    xd = torch.as_tensor(x, device=device)
    before = sqdist.LAUNCHES
    d = distance_matrix(xd)
    assert d.device == xd.device and sqdist.LAUNCHES == before + 1
    out = rips_at_scale(xd, maxdim=1, thresh=2.5)
    cpu = rips_at_scale(x, maxdim=1, thresh=2.5, device="cpu")
    assert sqdist.LAUNCHES == before + 2
    # the card's matrix (kernel) and the CPU's (plain version) are both
    # expansion forms summed in other orders: 1e-4, as tests/test_scale_ops.py
    for got, want in zip(out["dgms"], cpu["dgms"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(np.sort(got, axis=0), np.sort(want, axis=0), rtol=1e-4)


def test_the_scale_path_through_the_hopper_kernel_matches_the_cpu(device):
    """The two-cluster recipe at 2 x 80 points, past SM90_MIN_N.  Both
    matrices are expansion forms; a truncated tensor-core step at |x|^2 ~
    128 moves a distance near 0.34 by ~5e-5, so the diagrams are held to
    chip_smoke's bottleneck bound (SMALL_BOTTLENECK_TOL, 1e-4)."""
    from tdax_torch.metrics.persistence import bottleneck_distance
    from tdax_torch.pipeline.scale import rips_at_scale
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 0.5, (80, 8)),
                        rng.normal(4, 0.5, (80, 8))]).astype(np.float32)
    before = _counts()
    out = rips_at_scale(torch.as_tensor(x, device=device), maxdim=1, thresh=2.5)
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    cpu = rips_at_scale(x, maxdim=1, thresh=2.5, device="cpu")
    for got, want in zip(out["dgms"], cpu["dgms"]):
        assert got.shape == want.shape
        assert bottleneck_distance(got, want) <= 1e-4


def test_the_scale_path_launches_the_hopper_kernel_once(device):
    from tdax_torch.pipeline.scale import rips_at_scale
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(300, 64)).astype(np.float32), device=device)
    before = _counts()
    out = rips_at_scale(x, maxdim=1, thresh=9.0)
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert len(out["dgms"]) == 2 and all(np.isfinite(g[:, 0]).all() for g in out["dgms"])


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    with pytest.raises(TypeError):
        sqdist.pairwise_sq_euclidean_cuda(torch.zeros((4, 4), device=device,
                                                      dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        sqdist.pairwise_sq_euclidean_cuda(torch.zeros((4, 4), device=device).T)
