"""The port's capture slice end to end against tdax, on the CPU.

Dataset, tokenization and the whole ``extract_activations`` entry point
on 10 samples at batch 4 (a ragged tail), tiny f32 config, the same
parameters in both packages: activations agree at rtol = atol = 1e-4.
Also the ``.pt`` / ``.npz`` schemas (tdax's loader reads the port's
files) and the ``.tmp.npz`` resume, including its stale-id guard.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from PIL import Image

from tdax.config import DatasetConfig as JDatasetConfig
from tdax.config import ExtractConfig as JExtractConfig
from tdax.data import generate_dataset as j_generate_dataset
from tdax.data.io import load_activations as j_load_activations
from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.models.qwen_vl.preprocess import load_image_batch as j_load_image_batch
from tdax.models.qwen_vl.tokenizer import ToyTokenizer as JToyTokenizer
from tdax.models.qwen_vl.tokenizer import batch_encode as j_batch_encode
from tdax.pipeline.extract import extract_activations as j_extract_activations

from tdax_torch.config import DatasetConfig, ExtractConfig
from tdax_torch.data.dataset import generate_dataset
from tdax_torch.data.io import dump_json, load_activations_npz, load_metadata
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.convert import params_from_numpy
from tdax_torch.models.qwen_vl.preprocess import load_image_batch
from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer, batch_encode
from tdax_torch.pipeline.extract import extract_activations

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
N = 10


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_extract_ds")
    port = generate_dataset(DatasetConfig(data_dir=str(root / "port")))
    ref = j_generate_dataset(JDatasetConfig(data_dir=str(root / "tdax")))
    return port, ref


@pytest.fixture(scope="module")
def params():
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(5), JCFG))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu", "float32")


def _ecfg(save_interval=100):
    return ExtractConfig(batch_size=4, save_interval=save_interval)


def _stack(results, metadata):
    return np.stack([np.stack([results[m["id"]]["activations"][f"layer_{i}"]
                               for m in metadata]) for i in range(CFG.num_layers)])


def test_dataset_matches_tdax(dataset, tmp_path):
    port, ref = dataset
    assert len(port) == 48
    strip = [{k: v for k, v in m.items() if k != "image_path"} for m in port]
    assert strip == [{k: v for k, v in m.items() if k != "image_path"} for m in ref]
    assert [os.path.basename(m["image_path"]) for m in port] == \
        [os.path.basename(m["image_path"]) for m in ref]
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(Image.open(a["image_path"])),
                                      np.asarray(Image.open(b["image_path"])))
    on_disk = load_metadata(os.path.join(os.path.dirname(port[0]["image_path"]),
                                         "..", "metadata.json"))
    assert on_disk == port
    dump_json(port[:2], str(tmp_path / "two.json"))
    assert load_metadata(str(tmp_path / "two.json")) == port[:2]


def test_tokenization_and_images_match_tdax(dataset):
    port, _ = dataset
    got = batch_encode(ToyTokenizer(CFG), port[:N], CFG)
    want = j_batch_encode(JToyTokenizer(JCFG), port[:N], JCFG)
    assert set(got) == set(want)
    for key in ("input_ids", "attn_mask", "last_token_idx", "image_positions"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["image_paths"] == want["image_paths"]
    full = batch_encode(ToyTokenizer(QwenVLConfig()), port, QwenVLConfig())
    assert full["input_ids"].shape[1] == 299  # longest sequence: max_len 320
    paths = got["image_paths"][:3]
    np.testing.assert_array_equal(load_image_batch(paths, 56), j_load_image_batch(paths, 56))


def test_extract_matches_tdax(dataset, params, tmp_path):
    port, _ = dataset
    jp, tp = params
    metadata = port[:N]
    want = j_extract_activations(metadata, str(tmp_path / "tdax.pt"), JCFG,
                                 JExtractConfig(model_dir=None, batch_size=4,
                                                save_interval=100),
                                 params=jp, verbose=False)
    got = extract_activations(metadata, str(tmp_path / "port.pt"), CFG, _ecfg(),
                              params=tp, device="cpu", verbose=False)
    assert list(got) == [m["id"] for m in metadata]
    g, w = _stack(got, metadata), _stack(want, metadata)
    assert g.shape == (CFG.num_layers, N, CFG.hidden_size)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_output_schemas(dataset, params, tmp_path):
    port, _ = dataset
    _, tp = params
    metadata = port[:N]
    out = str(tmp_path / "all_activations.pt")
    results = extract_activations(metadata, out, CFG, _ecfg(), params=tp, device="cpu",
                                  verbose=False)
    acts, ids, meta = load_activations_npz(str(tmp_path / "all_activations.npz"))
    assert acts.shape == (CFG.num_layers, N, CFG.hidden_size) and acts.dtype == np.float32
    assert ids == [m["id"] for m in metadata] and meta == metadata
    with np.load(str(tmp_path / "all_activations.npz")) as z:
        assert set(z.files) == {"activations", "sample_ids", "metadata_json"}
        assert json.loads(str(z["metadata_json"])) == metadata
    # tdax's own loader reads the port's files (the reference's schema)
    for path in (out, str(tmp_path / "all_activations.npz")):
        loaded = j_load_activations(path)
        assert list(loaded) == ids
        entry = loaded[ids[3]]
        assert entry["metadata"] == metadata[3]
        assert list(entry["activations"]) == [f"layer_{i}" for i in range(CFG.num_layers)]
        np.testing.assert_allclose(entry["activations"]["layer_2"], acts[2, 3], rtol=0, atol=0)
    assert results[ids[3]]["metadata"] == metadata[3]
    assert not os.path.exists(out + ".tmp.npz")


def test_checkpoint_resume_matches_uninterrupted_run(dataset, params, tmp_path):
    port, _ = dataset
    _, tp = params
    metadata = port[:N]
    kw = dict(cfg=CFG, params=tp, device="cpu", verbose=False)
    full = extract_activations(metadata, str(tmp_path / "full.pt"),
                               extract_cfg=_ecfg(save_interval=4), **kw)

    # a crashed run: its first 8 samples sit in the checkpoint slot
    out = str(tmp_path / "resume.pt")
    extract_activations(metadata[:8], out, extract_cfg=_ecfg(save_interval=4), **kw)
    os.replace(str(tmp_path / "resume.npz"), out + ".tmp.npz")
    os.remove(out)

    resumed = extract_activations(metadata, out, extract_cfg=_ecfg(save_interval=4), **kw)
    assert set(resumed) == {m["id"] for m in metadata}
    np.testing.assert_allclose(_stack(resumed, metadata), _stack(full, metadata),
                               rtol=1e-5, atol=1e-6)
    assert not os.path.exists(out + ".tmp.npz")


def test_stale_checkpoint_is_ignored(dataset, params, tmp_path, capsys):
    port, _ = dataset
    _, tp = params
    kw = dict(cfg=CFG, extract_cfg=_ecfg(), params=tp, device="cpu", verbose=False)
    other = str(tmp_path / "other.pt")
    extract_activations(port[N:N + 4], other, **kw)   # ids foreign to the next run
    out = str(tmp_path / "run.pt")
    os.replace(str(tmp_path / "other.npz"), out + ".tmp.npz")
    results = extract_activations(port[:4], out, **kw)
    assert "stale checkpoint" in capsys.readouterr().out
    assert list(results) == [m["id"] for m in port[:4]]
    assert not os.path.exists(out + ".tmp.npz")
