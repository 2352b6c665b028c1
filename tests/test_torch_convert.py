"""The port's Hugging Face checkpoint loader against tdax's, on the CPU.

The checkpoint is tdax's own synthetic one (``random_hf_state`` and
``random_hf_visual_state`` at the tiny config, a 4 x 4 query grid
upsampled to an 8 x 8 patch grid), written in the layouts a snapshot can
have.  Tolerances:

  * the converted tree equals tdax's converter output leaf for leaf,
    exactly, in f32, and equals ``params_from_numpy`` of tdax's tree
    bitwise in bf16 (both round once from the same f32 value);
  * ``quantize`` from an f32 snapshot equals tdax's ``quantize_params``
    of its f32 tree exactly (q and s), and differs from quantizing the
    bf16-rounded weights, which is what the loader must not do;
  * the tiny multimodal capture from the snapshot is within 1e-4 (rtol
    and atol) of tdax's capture from its own loader (the capture slice's
    tolerance, tests/test_torch_extract.py), and bitwise equal to the
    port's capture from the same state converted in memory.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from tdax.config import ExtractConfig as JExtractConfig
from tdax.data import generate_dataset as j_generate_dataset
from tdax.config import DatasetConfig as JDatasetConfig
from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl.convert import convert_hf_state_dict as j_convert
from tdax.models.qwen_vl.convert import load_hf_state_dict as j_load_hf_state_dict
from tdax.models.qwen_vl.convert import load_qwen_checkpoint as j_load_qwen_checkpoint
from tdax.models.qwen_vl.quantize import quantize_params as j_quantize_params
from tdax.pipeline.extract import extract_activations as j_extract_activations

from tdax_torch.config import ExtractConfig
from tdax_torch.models.qwen_vl.config import QwenVLConfig, VisualConfig
from tdax_torch.models.qwen_vl.convert import (convert_hf_state_dict, load_hf_state_dict,
                                               load_qwen_checkpoint, params_from_numpy,
                                               params_to_numpy)
from tdax_torch.pipeline.extract import extract_activations

from tests.test_checkpoint_convert import VCFG, _write_sharded_safetensors, random_hf_visual_state
from tests.test_model import random_hf_state

JCFG = dataclasses.replace(JConfig.tiny(dtype="float32"), visual=VCFG)
CFG = dataclasses.replace(QwenVLConfig.tiny(dtype="float32"),
                          visual=VisualConfig(**dataclasses.asdict(VCFG)))


@pytest.fixture(scope="module")
def state():
    s = random_hf_state(JCFG)
    s.update(random_hf_visual_state(VCFG))
    return s


def _bf16(state):
    return {k: torch.tensor(v).to(torch.bfloat16).float().numpy() for k, v in state.items()}


def _assert_tree_equal(got: dict, want: dict, path=""):
    """Same leaves (any key order), same dtype, bitwise equal, contiguous."""
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
        else:
            assert got[k].dtype == want[k].dtype, f"{path}.{k}"
            assert got[k].is_contiguous(), f"{path}.{k}"
            assert torch.equal(got[k], want[k]), f"{path}.{k}"


def _write_bin_shards(state, out_dir, n_shards=3, dtype=torch.bfloat16):
    """The reference snapshot's layout: pytorch_model-0000k-of-0000N.bin
    and pytorch_model.bin.index.json, plus an empty shard file."""
    keys = sorted(state)
    per = -(-len(keys) // n_shards)
    weight_map = {}
    for s in range(n_shards):
        name = f"pytorch_model-{s + 1:05d}-of-{n_shards:05d}.bin"
        part = {k: torch.tensor(state[k]).to(dtype) for k in keys[s * per:(s + 1) * per]}
        torch.save(part, os.path.join(out_dir, name))
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(out_dir, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    open(os.path.join(out_dir, "pytorch_model-00000-of-00000.bin"), "w").close()


def _write(layout, state, out_dir):
    if layout == "safetensors_sharded":
        _write_sharded_safetensors(state, out_dir)
    elif layout == "safetensors_single":
        from safetensors.torch import save_file
        save_file({k: torch.tensor(v).to(torch.bfloat16) for k, v in state.items()},
                  os.path.join(out_dir, "model.safetensors"))
    else:
        _write_bin_shards(state, out_dir)


def test_convert_matches_tdax_exactly_in_f32(state):
    got = convert_hf_state_dict(state, CFG, "cpu")
    want = j_convert(state, JCFG)
    assert list(got) == list(want) and list(got["visual"]) == list(want["visual"])
    assert list(got["visual"]["resampler"]) == list(want["visual"]["resampler"])
    _assert_tree_equal(got, params_from_numpy(want, "cpu", torch.float32))
    # the decoder alone: no visual key, no visual tree (as tdax)
    text = {k: v for k, v in state.items() if not k.startswith("transformer.visual.")}
    got = convert_hf_state_dict(text, CFG, "cpu")
    assert "visual" not in got
    _assert_tree_equal(got, params_from_numpy(j_convert(text, JCFG), "cpu", torch.float32))


@pytest.mark.parametrize("layout", ["safetensors_sharded", "safetensors_single", "bin_index"])
def test_snapshot_layouts_load_as_tdax_loads_them(state, tmp_path, layout):
    _write(layout, state, str(tmp_path))
    raw = load_hf_state_dict(str(tmp_path))
    want_raw = j_load_hf_state_dict(str(tmp_path))
    assert sorted(raw) == sorted(want_raw)
    for k, v in want_raw.items():
        assert raw[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(raw[k].float().numpy(), v)
    got = load_qwen_checkpoint(str(tmp_path), CFG, "cpu")
    _assert_tree_equal(got, params_from_numpy(j_load_qwen_checkpoint(str(tmp_path), JCFG),
                                              "cpu", torch.float32))


def test_bf16_load_equals_params_from_numpy_of_tdax_tree(state, tmp_path):
    _write_bin_shards(state, str(tmp_path), dtype=torch.float32)
    want = params_from_numpy(j_load_qwen_checkpoint(str(tmp_path), JCFG), "cpu", torch.bfloat16)
    got = load_qwen_checkpoint(str(tmp_path), CFG, "cpu", torch.bfloat16)
    _assert_tree_equal(got, want)
    bf16_cfg = dataclasses.replace(CFG, dtype="bfloat16")
    _assert_tree_equal(load_qwen_checkpoint(str(tmp_path), bf16_cfg, "cpu"), want)


def test_int8_from_an_f32_snapshot_quantizes_the_values_as_read(state, tmp_path):
    _write_bin_shards(state, str(tmp_path), dtype=torch.float32)
    tdax_tree = j_load_qwen_checkpoint(str(tmp_path), JCFG)
    want = params_from_numpy(jax.tree.map(np.asarray, j_quantize_params(tdax_tree)), "cpu",
                             torch.bfloat16)
    got = load_qwen_checkpoint(str(tmp_path), CFG, "cpu", torch.bfloat16, quantize=True)
    _assert_tree_equal(got, want)
    assert got["layers"]["mlp_w1"]["q"].dtype == torch.int8
    # quantizing the bf16-rounded weights would give other scales
    rounded = params_from_numpy(jax.tree.map(np.asarray, j_quantize_params(
        j_convert(_bf16(state), JCFG))), "cpu", torch.bfloat16)
    assert not torch.equal(got["layers"]["mlp_w1"]["s"], rounded["layers"]["mlp_w1"]["s"])


def _duplicate(tmp_path):
    from safetensors.torch import save_file
    t = {"transformer.ln_f.weight": torch.ones(4)}
    save_file(t, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(t, str(tmp_path / "model-00002-of-00002.safetensors"))


def _duplicate_bin(tmp_path):
    t = {"transformer.ln_f.weight": torch.ones(4)}
    torch.save(t, str(tmp_path / "pytorch_model-00001-of-00002.bin"))
    torch.save(t, str(tmp_path / "pytorch_model-00002-of-00002.bin"))


def _only_empty_shards(tmp_path):
    (tmp_path / "pytorch_model-00001-of-00001.bin").write_bytes(b"")


@pytest.mark.parametrize("make,error,match", [
    (_duplicate, ValueError, "duplicate"),
    (_duplicate_bin, ValueError, "duplicate"),
    (lambda p: None, FileNotFoundError, "no checkpoint shards"),
    (_only_empty_shards, FileNotFoundError, "no checkpoint shards"),
])
def test_bad_snapshots_raise(tmp_path, make, error, match):
    make(tmp_path)
    with pytest.raises(error, match=match):
        load_hf_state_dict(str(tmp_path))
    with pytest.raises(error, match=match):
        load_qwen_checkpoint(str(tmp_path), CFG, "cpu")


def test_missing_layer_key_raises_naming_it(state, tmp_path):
    gone = "transformer.h.3.mlp.w2.weight"
    _write_bin_shards({k: v for k, v in state.items() if k != gone}, str(tmp_path))
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        load_qwen_checkpoint(str(tmp_path), CFG, "cpu")
    gone = "transformer.visual.transformer.resblocks.1.attn.in_proj_bias"
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        convert_hf_state_dict({k: v for k, v in state.items() if k != gone}, CFG, "cpu")


def test_a_layer_of_another_shape_raises(state):
    """tdax's np.stack refuses ragged layers; the loader must not broadcast."""
    key = "transformer.h.2.attn.c_attn.bias"
    ragged = {**state, key: state[key][:1]}
    with pytest.raises(ValueError, match="attn_qkv_b layer 2"):
        convert_hf_state_dict(ragged, CFG, "cpu")
    with pytest.raises(ValueError):
        j_convert(ragged, JCFG)


def test_resampler_pos_embed_defaults_to_the_query_grid_table(state):
    """A checkpoint without attn_pool.pos_embed: the sincos table, as tdax."""
    gone = "transformer.visual.attn_pool.pos_embed"
    cut = {k: v for k, v in state.items() if k != gone}
    got = params_to_numpy(convert_hf_state_dict(cut, CFG, "cpu")["visual"]["resampler"])
    want = j_convert(cut, JCFG)["visual"]["resampler"]
    for key in ("q_pos", "kv_pos"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["kv_pos"].shape == (VCFG.n_patches, VCFG.output_dim)


@pytest.fixture(scope="module")
def snapshot(state, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_convert_snapshot")
    _write_sharded_safetensors(state, str(root))
    metadata = j_generate_dataset(JDatasetConfig(data_dir=str(root / "ds")))[:6]
    return str(root), metadata


def _stack(results, metadata, n_layers):
    return np.stack([np.stack([results[m["id"]]["activations"][f"layer_{i}"] for m in metadata])
                     for i in range(n_layers)])


def test_capture_from_the_snapshot_matches_tdax_and_the_in_memory_tree(state, snapshot,
                                                                       tmp_path):
    snap, metadata = snapshot
    want = j_extract_activations(metadata, str(tmp_path / "tdax.pt"), JCFG,
                                 JExtractConfig(model_dir=snap, batch_size=4), verbose=False)
    got = extract_activations(metadata, str(tmp_path / "port.pt"), CFG,
                              ExtractConfig(model_dir=snap, batch_size=4), device="cpu",
                              verbose=False)
    mem = extract_activations(metadata, str(tmp_path / "mem.pt"), CFG,
                              ExtractConfig(model_dir=None, batch_size=4),
                              params=convert_hf_state_dict(_bf16(state), CFG, "cpu"),
                              device="cpu", verbose=False)
    g = _stack(got, metadata, CFG.num_layers)
    assert g.shape == (CFG.num_layers, len(metadata), CFG.hidden_size) and np.isfinite(g).all()
    np.testing.assert_allclose(g, _stack(want, metadata, CFG.num_layers), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(g, _stack(mem, metadata, CFG.num_layers))


def test_extract_command_loads_the_model_dir(snapshot, tmp_path, monkeypatch, capsys):
    """``python -m tdax_torch extract --toy --model-dir DIR --device cpu``
    captures from the snapshot; an explicit directory without shards
    raises instead of drawing random weights."""
    from tdax_torch.__main__ import main
    from tdax_torch.config import DatasetConfig
    from tdax_torch.data.io import load_activations_npz
    snap, _ = snapshot
    monkeypatch.chdir(tmp_path)
    main(["generate"])
    # the tiny config with the snapshot's 8 x 8 patch grid
    monkeypatch.setattr(QwenVLConfig, "tiny", classmethod(lambda cls, **kw: CFG))
    main(["extract", "--toy", "--model-dir", snap, "--device", "cpu"])
    assert f"the checkpoint in {snap}" in capsys.readouterr().out
    acts, ids, _ = load_activations_npz(DatasetConfig().activations_path.replace(".pt", ".npz"))
    assert acts.shape == (CFG.num_layers, 48, CFG.hidden_size) and np.isfinite(acts).all()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint shards"):
        main(["extract", "--toy", "--model-dir", str(tmp_path / "empty"), "--device", "cpu"])
