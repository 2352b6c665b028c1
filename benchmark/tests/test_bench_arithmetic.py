"""The yardstick reproduces the bounds the port's kernel table (PERF.md)
was measured against, from the model's shapes alone."""

import pytest

from benchmark import roofline, spec, work

MD = work.model(spec.cell("qwen-vl-chat.capture").config)


def test_flash_forward_per_capture_batch():
    w = work.capture_batch(MD, 16, 320)
    assert w.attn_fwd_bound_s() * 1e3 == pytest.approx(7.123, abs=5e-4)


def test_flash_backward_per_training_step():
    dq, dkv = roofline.attn_bwd_pair_bound(4, 1024, 1024, 32, 128, True)
    assert 32 * dq * 1e3 == pytest.approx(1.669, abs=5e-4)
    assert 32 * dkv * 1e3 == pytest.approx(2.226, abs=5e-4)
    assert work.train_step(MD, 4, 1024, True).attn_bwd_bound_s() == pytest.approx(32 * (dq + dkv))


def test_flash_forward_training_call():
    assert roofline.attn_fwd_bound(4, 1024, 1024, 32, 128, True) * 1e3 == pytest.approx(
        0.0401, abs=5e-5)
    assert work.train_step(MD, 4, 1024, True).attn_fwd == [((4, 1024, 1024, 32, 128, True), 64)]


def test_qmm_per_int8_capture_batch():
    products = work.capture_qmm(MD, 16, 320)
    assert sum(n for _, n in products) == 359
    w = work.Work(flops=0.0, qmm=products)
    assert w.qmm_bound_s() * 1e3 == pytest.approx(129.81, abs=5e-3)


def test_train_flops_at_4x1024():
    # 3 x (4096 tokens x (32 x 2 x (4096 x 12288 + 4096^2 + 3 x 4096 x 11008)
    #      + 2 x 4096 x 151936) + 32 x 4 x 1024^2 x 4096 x 4)
    per_token = 32 * 2 * (4096 * 12288 + 4096 ** 2 + 3 * 4096 * 11008) + 2 * 4096 * 151936
    want = 3 * (4096 * per_token + 32 * 4 * 1024 ** 2 * 4096 * 4)
    assert work.train_flops(MD, 4, 1024) == want
    # PERF.md's training step: 0.7255 s at 25.2% of 989 TFLOP/s
    assert want / 0.7255 / roofline.BF16_PEAK == pytest.approx(0.252, abs=5e-4)


def test_capture_flops_by_part():
    total = work.capture_batch(MD, 16, 320).flops
    assert total == pytest.approx(134.2e12, rel=2e-3)


def test_causal_pairs():
    assert roofline.visible_pairs(4, 4, True) == 10
    assert roofline.visible_pairs(4, 6, False) == 24


@pytest.mark.parametrize("shape,ms", [
    ((16, 320, 320, 32, 128, True), None),                   # the captures' decoder
    ((16, 1024, 1024, 16, 104, False), None),                # the visual tower
    ((16, 256, 1024, 32, 128, False), None),                 # the resampler
    ((4, 1024, 1024, 32, 128, True), 0.0401),                # the training call
])
def test_value_width_defaults_to_the_head_width(shape, ms):
    """``hd_v`` left out or equal to ``hd`` gives the bound as before,
    bitwise: 4 b nh tq tk hd flops, (2 b tq + 2 b tk) nh hd bytes."""
    b, tq, tk, nh, hd, causal = shape
    flops = 4.0 * b * nh * tq * tk * hd / (2 if causal else 1)
    nbytes = (2 * b * tq + 2 * b * tk) * nh * hd * 2 + 4 * b * tk
    want = max(flops / roofline.BF16_PEAK, nbytes / roofline.HBM_BYTES_PER_S)
    assert roofline.attn_fwd_bound(*shape) == want
    assert roofline.attn_fwd_bound(*shape, hd_v=hd) == want
    if ms is not None:
        assert want * 1e3 == pytest.approx(ms, abs=5e-5)


def test_latent_attention_value_width():
    """MLA's q.k over 128 + 64 dimensions and v of 128, worked by hand.
    Prefill, 1 x 4096 causal, 16 heads: 2 x 16 x 4096^2 x (192 + 128) / 2
    = 85,899,345,920 flops; bytes (4096 + 4096) x 16 x 320 x 2 + 4 x 4096
    = 83,902,464: compute bound.  Decode, one query over 4096 keys:
    2 x 16 x 4096 x 320 = 41,943,040 flops; (1 + 4096) x 16 x 320 x 2 +
    16,384 = 41,969,664 bytes: memory bound."""
    prefill = roofline.attn_fwd_bound(1, 4096, 4096, 16, 192, True, hd_v=128)
    assert prefill == 85_899_345_920 / roofline.BF16_PEAK
    assert prefill * 1e6 == pytest.approx(86.855, abs=5e-4)
    decode = roofline.attn_fwd_bound(1, 1, 4096, 16, 192, False, hd_v=128)
    assert decode == 41_969_664 / roofline.HBM_BYTES_PER_S
    assert decode * 1e6 == pytest.approx(12.528, abs=5e-4)
    # counting v and o at q's width would count 25% more of both
    assert roofline.attn_fwd_bound(1, 4096, 4096, 16, 192, True) > 1.19 * prefill
