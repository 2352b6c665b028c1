"""The CUDA sqdist kernel against its plain version, on the card.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_sqdist_cuda.py

Tolerance: both sides are expansion forms summed in different orders
(the kernel in one f32 FMA chain per entry, the plain version through a
library product), so |kernel - plain| <= 1e-5 * (|x_i|^2 + |x_j|^2).
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


def test_kernel_reads_a_strided_view(device):
    """Rows with a stride larger than d, a base offset off the 16-byte grid."""
    base = torch.randn((90, 70), device=device)
    x = base[3:, 1:66]
    got = sqdist.pairwise_sq_euclidean_cuda(x)
    _assert_close(got, x.contiguous())


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


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    with pytest.raises(TypeError):
        sqdist.pairwise_sq_euclidean_cuda(torch.zeros((4, 4), device=device,
                                                      dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        sqdist.pairwise_sq_euclidean_cuda(torch.zeros((4, 4), device=device).T)
