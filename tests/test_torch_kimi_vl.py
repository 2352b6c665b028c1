"""Kimi-VL-A3B-Instruct in the port against the plain f32 reference
(``benchmark/reference/kimi_vl.py``), at the tiny size on the CPU, on
seeded random weights in f32.

Tolerances: both sides compute in f32 on the same weights and inputs,
in other orders (fused [gate | up] and [q_nope | q_pe] products, the
rotary written in real and in complex arithmetic, the flash plain
version's softmax against the reference's), so vectors agree to a few
f32 ulps per operation: 1e-4 relative per vector over the tiny model's 3
blocks leaves two orders of magnitude of room above what they read
(~2e-6), and a wrong order, table or equation reads 1e-2 or more.
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.jobs.capture_kimi_vl import kimi_tiny
from benchmark.reference import numerics
from benchmark.reference.kimi_vl import Model
from tdax_torch.models.kimi_vl import KimiVLConfig, init_params, model
from tdax_torch.models.kimi_vl import decoder, moonvit
from tdax_torch.ops import moe
from tdax_torch.ops.flash_attention import AttnSpec

CFG = KimiVLConfig.tiny(dtype="float32")
with open("benchmark/configs/kimi-vl-a3b-instruct.json") as _f:
    FILE_CFG = kimi_tiny(json.load(_f), "float32")
TOL = 1e-4


def _rel(got, want):
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, "cpu", seed=3)


@pytest.fixture(scope="module")
def reference(params):
    return Model(params, FILE_CFG, numerics.named("float32"))


def _batch(seed=0, b=3):
    g = torch.Generator().manual_seed(seed)
    t, nq = 64, CFG.visual.n_queries
    ids = torch.randint(1, CFG.vocab_size, (b, t), generator=g)
    mask = torch.ones((b, t), dtype=torch.int32)
    mask[1, 50:] = 0
    last = torch.tensor([63, 49, 40][:b])
    images = torch.randn((b, 3, CFG.visual.image_size, CFG.visual.image_size), generator=g)
    pos = torch.arange(4, 4 + nq)[None].repeat(b, 1)
    return ids, mask, last, images, pos


def test_file_config_is_the_tiny_config():
    assert FILE_CFG["num_hidden_layers"] == CFG.num_layers == 3
    assert FILE_CFG["vision_config"]["init_pos_emb_height"] == CFG.visual.pos_grid > (
        CFG.visual.grid_size)
    assert (CFG.qk_nope_head_dim, CFG.qk_rope_head_dim, CFG.v_head_dim) == (16, 8, 16)
    assert CFG.visual.head_dim % 4 == 0 and CFG.n_dense == 1 and CFG.n_moe == 2


def test_whole_capture_matches_reference(params, reference):
    got = model.extract_layer_activations(params, CFG, *_batch())
    want = reference.capture(*_batch())
    assert got.shape == (CFG.num_layers, 3, CFG.hidden_size)
    assert _rel(got, want) < TOL


def test_moonvit_matches_reference(params, reference):
    images = _batch()[3]
    got = moonvit.visual_encode(images, params["visual"], CFG.visual)
    assert got.shape == (3, CFG.visual.n_queries, CFG.hidden_size)
    assert _rel(got, reference.visual(images)) < TOL


def test_moonvit_rope_is_the_formula():
    """Pair 2i of a head turns by the patch's column times f_i, pair 2i + 1
    by its row times f_i, f_i = theta^(-4 i / hd)."""
    g, hd, theta = 5, 16, 10000.0
    cos, sin = moonvit.rope_2d(g, hd, theta, "cpu")
    x = torch.randn((1, g * g, 1, hd), dtype=torch.float64).float()
    out = moonvit.apply_rope_2d(x, cos, sin)
    for patch in (0, 7, 23):
        row, col = divmod(patch, g)
        for pair in range(hd // 2):
            f = theta ** (-4 * (pair // 2) / hd)
            angle = (col if pair % 2 == 0 else row) * f
            a, b = x[0, patch, 0, 2 * pair], x[0, patch, 0, 2 * pair + 1]
            want = (a * math.cos(angle) - b * math.sin(angle),
                    a * math.sin(angle) + b * math.cos(angle))
            got = out[0, patch, 0, 2 * pair:2 * pair + 2]
            assert torch.allclose(got, torch.tensor(want, dtype=torch.float32), atol=1e-5)


def test_moonvit_merge_order():
    """Token (r', c') holds patches (r, c), (r, c + 1), (r + 1, c), (r + 1,
    c + 1) of r = 2 r', c = 2 c', in that order."""
    vis = CFG.visual
    g = vis.grid_size
    x = torch.arange(g * g, dtype=torch.float32)[None, :, None].repeat(2, 1, 3)
    merged = moonvit.merge(x, vis)
    assert merged.shape == (2, (g // 2) ** 2, 4, 3)
    for r in range(g // 2):
        for c in range(g // 2):
            want = [(2 * r) * g + 2 * c, (2 * r) * g + 2 * c + 1, (2 * r + 1) * g + 2 * c,
                    (2 * r + 1) * g + 2 * c + 1]
            assert merged[1, r * (g // 2) + c, :, 0].tolist() == want


def test_moonvit_position_table_is_resized_once(params):
    vis = CFG.visual
    first = moonvit.grid_tables(params["visual"], vis, "cpu")
    assert first[0].shape == (vis.grid_size ** 2, vis.width) and vis.pos_grid != vis.grid_size
    table = params["visual"]["pos_table"].reshape(1, vis.pos_grid, vis.pos_grid, -1)
    want = F.interpolate(table.permute(0, 3, 1, 2), size=(vis.grid_size,) * 2, mode="bicubic",
                         align_corners=False).permute(0, 2, 3, 1).reshape(vis.grid_size ** 2, -1)
    torch.testing.assert_close(first[0], want)
    assert all(a is b for a, b in zip(first, moonvit.grid_tables(params["visual"], vis, "cpu")))


def test_mla_against_a_per_head_reference(params):
    """Latent attention against one head at a time: k = [k_nope | k_pe]
    and v built explicitly from the latent, causal softmax in f64."""
    x = torch.randn((2, 20, CFG.hidden_size), generator=torch.Generator().manual_seed(5))
    mask = torch.ones((2, 20), dtype=torch.int32)
    mask[0, 15:] = 0
    layer = {k: v[1] for k, v in params["layers"].items()}
    cos, sin = decoder.rope_cos_sin(20, CFG.qk_rope_head_dim, CFG.rope_theta, "cpu")
    got = decoder.mla(x, layer, CFG, cos, sin, AttnSpec(mask, True))

    dn, dr, dv, r = CFG.qk_nope_head_dim, CFG.qk_rope_head_dim, CFG.v_head_dim, CFG.kv_lora_rank
    xd = x.double()
    n = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + CFG.rms_norm_eps)
    ckv = n @ layer["kv_a_w"].double()
    c = ckv[..., :r]
    c = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + CFG.kv_norm_eps)
    kv = (c @ layer["kv_b_w"].double()).view(2, 20, CFG.num_heads, dn + dv)
    q = (n @ layer["q_w"].double()).view(2, 20, CFG.num_heads, dn + dr)
    pos = torch.arange(20, dtype=torch.float64)

    def turn(z):  # pairs (2j, 2j + 1) by pos f_j, laid out [firsts | seconds]
        f = CFG.rope_theta ** (-torch.arange(0, dr, 2, dtype=torch.float64) / dr)
        ang = pos[:, None] * f
        a, b = z[..., 0::2], z[..., 1::2]
        return torch.cat([a * ang.cos() - b * ang.sin(), b * ang.cos() + a * ang.sin()], -1)

    k_pe = turn(ckv[..., r:])
    heads = []
    for h in range(CFG.num_heads):
        qh = torch.cat([q[:, :, h, :dn], turn(q[:, :, h, dn:])], -1)
        kh = torch.cat([kv[:, :, h, :dn], k_pe], -1)
        s = qh @ kh.transpose(1, 2) / math.sqrt(dn + dr)
        allowed = torch.ones((20, 20), dtype=torch.bool).tril() & (mask[:, None, :] > 0)
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
        heads.append(p @ kv[:, :, h, dn:])
    want = torch.cat(heads, -1) @ layer["o_w"].double()
    assert _rel(got.double(), want) < TOL


def test_router_picks_by_the_bias_and_weighs_without_it():
    g = torch.Generator().manual_seed(7)
    h, w = torch.randn((40, 16), generator=g), torch.randn((16, 8), generator=g)
    zero = torch.zeros(8)
    picked, weights = moe.route(h, w, zero, 3, 2.446)
    s = torch.sigmoid(h @ w)
    assert torch.equal(picked, s.topk(3, dim=-1).indices)
    torch.testing.assert_close(weights.sum(-1), torch.full((40,), 2.446))
    bias = torch.zeros(8)
    bias[5] = 10.0  # expert 5 is picked first by every token, at its own score
    picked_b, weights_b = moe.route(h, w, bias, 3, 2.446)
    assert (picked_b[:, 0] == 5).all() and not torch.equal(picked_b, picked)
    w5 = s[:, 5] / s.gather(1, picked_b).sum(-1) * 2.446
    torch.testing.assert_close(weights_b[:, 0], w5)
    # the reference routes the same way
    ref = Model({}, {**FILE_CFG, "num_experts_per_tok": 3}, numerics.named("float32"))
    r_picked, r_weights = ref.route(h, {"router_w": w, "router_bias": bias})
    assert torch.equal(r_picked, picked_b)
    torch.testing.assert_close(r_weights, weights_b)


def test_router_ties_go_to_the_lower_expert():
    """Equal scores (a zero router row) pick the lowest indices, in the
    port and in the reference alike."""
    h = torch.zeros((4, 16))
    w = torch.randn((16, 8))
    bias = torch.tensor([0.0, 0.1, 0.0, 0.1, 0.0, 0.0, 0.1, 0.0])
    picked, weights = moe.route(h, w, bias, 3, 1.0)
    assert picked.tolist() == [[1, 3, 6]] * 4
    torch.testing.assert_close(weights, torch.full((4, 3), 1 / 3))
    ref = Model({}, {**FILE_CFG, "num_experts_per_tok": 3}, numerics.named("float32"))
    assert torch.equal(ref.route(h, {"router_w": w, "router_bias": bias})[0], picked)
    picked, _ = moe.route(h, w, torch.zeros(8), 3, 1.0)
    assert picked.tolist() == [[0, 1, 2]] * 4


def test_expert_layer_against_its_per_expert_loop(params):
    """The routed path (dispatch, grouped products, combine) against each
    token's k experts run one by one and summed with their weights."""
    layer = {k: v[0] for k, v in params["moe"].items()}
    h = torch.randn((50, CFG.hidden_size), generator=torch.Generator().manual_seed(9))
    got = moe.moe(h, layer, CFG.num_experts_per_tok, CFG.routed_scaling_factor, 1)
    picked, weights = moe.route(h, layer["router_w"], layer["router_bias"],
                                CFG.num_experts_per_tok, CFG.routed_scaling_factor)
    want = torch.zeros_like(h)
    for t in range(50):
        for j in range(CFG.num_experts_per_tok):
            e = int(picked[t, j])
            gate, up = (h[t] @ layer["experts_gate_up"][e]).chunk(2)
            want[t] += weights[t, j] * ((F.silu(gate) * up) @ layer["experts_down"][e])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_dense_layer_zero(params, reference):
    x = torch.randn((2, 10, CFG.hidden_size), generator=torch.Generator().manual_seed(11))
    got = decoder.ffn(x, params, CFG, 0)
    want = reference.ffn(x, 0, {k: v[0] for k, v in params["layers"].items()})
    assert _rel(got, want) < TOL


def test_extract_activations_writes_its_files(tmp_path):
    from tdax_torch.config import ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.config import DatasetConfig
    from tdax_torch.pipeline.extract import extract_activations

    ds = DatasetConfig(data_dir=str(tmp_path / "data"))
    metadata = generate_dataset(ds)[:5]
    out = str(tmp_path / "acts.pt")
    cfg = KimiVLConfig.tiny()
    results = extract_activations(metadata, out, cfg, ExtractConfig(batch_size=4, model_dir=None),
                                  device="cpu", verbose=False)
    assert len(results) == 5
    saved = np.load(str(tmp_path / "acts.npz"), allow_pickle=True)
    assert saved["activations"].shape == (cfg.num_layers, 5, cfg.hidden_size)
    assert (tmp_path / "acts.pt").exists()
    with pytest.raises(NotImplementedError):
        extract_activations(metadata, out, cfg, ExtractConfig(quantize_int8=True), device="cpu")
