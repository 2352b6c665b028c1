"""The CUDA int8 matmul kernels against their plain version, on the card:
``qmm_sm90.cu`` where the route sends a product, and ``qmm.cu`` as routed
or forced by the private ``_kernel="mma"``.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_qmm_cuda.py

Tolerances: bf16 ``|kernel - plain| <= 2^-7 |plain| + 1e-3 max|plain|``
(one bf16 rounding of the output, plus room for the order of the f32
sum; both kernels convert the int8 exactly and differ from the plain
version in the order of the sum alone); f32 ``<= 1e-5 (|x| @ |q| s)`` entrywise (the sum's rounding is
bounded by the sum of the magnitudes of its terms).
"""

import pytest
import torch

from tdax_torch.models.qwen_vl.quantize import qdot, quantize_weight
from tdax_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from tdax_torch.runtime import get_device
    return get_device()


def _weight(gen, k, n, device):
    w = torch.randn((k, n), generator=gen, device=device) / k ** 0.5
    return quantize_weight(w)


def _check(x, w, kernel=None):
    got = qm.quant_matmul(x, w["q"], w["s"], _kernel=kernel)
    want = qm.quant_matmul_plain(x, w["q"], w["s"])
    assert got.dtype == x.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if x.dtype == torch.bfloat16:
        limit = 2.0 ** -7 * want.float().abs() + 1e-3 * want.float().abs().max()
    else:
        limit = 1e-5 * (x.abs() @ w["q"].float().abs() * w["s"])
    assert (err <= limit).all(), float((err - limit).max())


@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (130, 588, 384), (1, 33, 7), (16, 4096, 4096),
                                   (64, 96, 48), (65, 64, 17), (300, 1664, 640), (3, 40, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(device, m, k, n, dtype):
    gen = torch.Generator(device=device).manual_seed(m * 7 + n)
    x = torch.randn((m, k), generator=gen, device=device).to(dtype)
    w = _weight(gen, k, n, device)
    launches = qm.LAUNCHES
    _check(x, w)
    assert qm.LAUNCHES == launches + 1


def test_kernel_reads_strided_and_broadcast_rows(device):
    """A column slice (row stride 3K), a broadcast view and a 3-D x."""
    gen = torch.Generator(device=device).manual_seed(5)
    w = _weight(gen, 256, 192, device)
    fused = torch.randn((4, 10, 3 * 256), generator=gen, device=device).to(torch.bfloat16)
    _check(fused[..., 256:512], w)
    row = torch.randn((1, 256), generator=gen, device=device).to(torch.bfloat16)
    _check(row.expand(6, 256), w)
    odd = torch.randn((5, 7, 255), generator=gen, device=device).to(torch.bfloat16)
    _check(odd[..., :250], _weight(gen, 250, 192, device))


def test_qdot_launches_the_kernel_on_the_card(device):
    gen = torch.Generator(device=device).manual_seed(6)
    w = _weight(gen, 64, 32, device)
    x = torch.randn((2, 3, 64), generator=gen, device=device)
    launches = qm.LAUNCHES
    out = qdot(x, w)
    assert qm.LAUNCHES == launches + 1 and out.shape == (2, 3, 32)


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    w = quantize_weight(torch.ones((8, 4), device=device))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        qm.quant_matmul(torch.zeros((2, 8), device=device, dtype=torch.float16), w["q"], w["s"])
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(torch.zeros((2, 8), device=device), w["q"].t().contiguous().t(), w["s"])
    with pytest.raises(ValueError, match="do not match"):
        qm.quant_matmul(torch.zeros((2, 9), device=device), w["q"], w["s"])
    with pytest.raises(ValueError, match="CUDA device"):
        qm.quant_matmul(torch.zeros((2, 8), device=device), w["q"].cpu(), w["s"])


@pytest.mark.parametrize("m,k,n", [(16384, 1664, 4992), (5120, 4096, 12288), (200, 1000, 1664)],
                         ids=["vit_qkv", "decoder_qkv", "ragged"])
@pytest.mark.parametrize("kernel", [None, "mma"], ids=["sm90", "mma_forced"])
def test_hopper_shapes_on_both_kernels(device, m, k, n, kernel):
    """A ViT and a decoder site of the capture and a ragged product (M, N
    and K off the 256 x 128 x 64 tile): the route sends each to
    qmm_sm90.cu; both kernels match the plain version and the counters
    move as the choice says."""
    gen = torch.Generator(device=device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = _weight(gen, k, n, device)
    assert qm._route(x, w["q"], w["s"]) == "sm90"
    before = (qm.LAUNCHES, qm.LAUNCHES_SM90)
    _check(x, w, kernel)
    assert (qm.LAUNCHES, qm.LAUNCHES_SM90) == (before[0] + 1, before[1] + (kernel is None))


def test_hopper_kernel_is_deterministic_and_reads_a_column_slice(device):
    """Two runs agree bitwise (one owner per output, a fixed sum order); a
    16-byte aligned column slice of a fused projection is read in place."""
    gen = torch.Generator(device=device).manual_seed(11)
    w = _weight(gen, 1664, 1664, device)
    fused = torch.randn((300, 3 * 1664), generator=gen, device=device).to(torch.bfloat16)
    x = fused[:, 1664:2 * 1664]
    assert qm._route(x, w["q"], w["s"]) == "sm90"
    _check(x, w)
    assert torch.equal(qm.quant_matmul(x, w["q"], w["s"]), qm.quant_matmul(x, w["q"], w["s"]))


def test_decode_and_f32_stay_on_the_mma_kernel(device):
    """Named for the kernel the decode step took before
    qmm_decode_sm90.cu: a bf16 decode product (M = 16) now takes the
    decode kernel; f32 and 65 to 127 rows stay on qmm.cu."""
    gen = torch.Generator(device=device).manual_seed(12)
    w = _weight(gen, 4096, 4096, device)
    sm90, decode = qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE
    x = torch.randn((16, 4096), generator=gen, device=device).to(torch.bfloat16)
    _check(x, w)
    assert (qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE) == (sm90, decode + 1)
    for x in (torch.randn((512, 4096), generator=gen, device=device),
              torch.randn((100, 4096), generator=gen, device=device).to(torch.bfloat16)):
        launches = qm.LAUNCHES
        _check(x, w)
        assert qm.LAUNCHES == launches + 1
    assert (qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE) == (sm90, decode + 1)
    with pytest.raises(ValueError, match="sm90 kernel does not take"):
        qm.quant_matmul(x[:16], w["q"], w["s"], _kernel="sm90")
    assert qm.LAUNCHES_SM90 == sm90


# (site, M, K, N): a decode step's products, a dp rank's rows, a tp rank's
# columns, and ragged M, K, N
DECODE_SHAPES = [("qkv", 16, 4096, 12288), ("attn_proj", 16, 4096, 4096),
                 ("mlp_w1", 16, 4096, 11008), ("mlp_proj", 16, 11008, 4096),
                 ("lm_head", 16, 4096, 151936), ("dp8_proj", 8, 4096, 4096),
                 ("tp_qkv", 8, 4096, 6144), ("ragged40", 40, 4104, 4112), ("m64", 64, 1024, 384),
                 ("m33", 33, 136, 272), ("m1", 1, 256, 128)]


@pytest.mark.parametrize("kernel", [None, "mma"], ids=["decode", "mma_forced"])
@pytest.mark.parametrize("case", DECODE_SHAPES, ids=[c[0] for c in DECODE_SHAPES])
def test_decode_shapes_on_both_kernels(device, case, kernel):
    """The route sends each to qmm_decode_sm90.cu; both kernels match the
    plain version, the counters move as the choice says, and the decode
    kernel repeats bitwise (its splits sum in a fixed order)."""
    _, m, k, n = case
    gen = torch.Generator(device=device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = _weight(gen, k, n, device)
    assert qm._route(x, w["q"], w["s"]) == "decode"
    before = (qm.LAUNCHES, qm.LAUNCHES_DECODE)
    _check(x, w, kernel)
    assert (qm.LAUNCHES, qm.LAUNCHES_DECODE) == (before[0] + 1, before[1] + (kernel is None))
    if kernel is None:
        assert torch.equal(qm.quant_matmul(x, w["q"], w["s"]), qm.quant_matmul(x, w["q"], w["s"]))


def test_decode_kernel_reads_a_column_slice_and_its_gradient_flows(device):
    """A 16-byte aligned column slice of a fused projection is read in
    place; with grad on, one decode launch and x's gradient is tdax's."""
    gen = torch.Generator(device=device).manual_seed(13)
    w = _weight(gen, 1024, 2048, device)
    fused = torch.randn((16, 3 * 1024), generator=gen, device=device).to(torch.bfloat16)
    x = fused[:, 1024:2048]
    assert qm._route(x, w["q"], w["s"]) == "decode"
    _check(x, w)
    xg = x.detach().clone().requires_grad_()
    decode = qm.LAUNCHES_DECODE
    qm.qmm(xg, w["q"], w["s"]).float().sum().backward()
    assert qm.LAUNCHES_DECODE == decode + 1
    xp = x.detach().clone().requires_grad_()
    qm.quant_matmul_plain(xp, w["q"], w["s"]).float().sum().backward()
    torch.testing.assert_close(xg.grad.float(), xp.grad.float(), rtol=3e-2, atol=3e-2)
