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
