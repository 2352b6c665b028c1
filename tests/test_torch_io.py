"""The port's activation IO against tdax's, on the CPU: each package's
``save_activations`` output, ``.npz`` and ``.pt``, reads back in the
other package's ``load_activations`` with equal values, and
``save_activations_pt`` round-trips the reference's nested dict."""

import zipfile

import numpy as np
import pytest
import torch

from tdax.data import io as jio

from tdax_torch.data import io as tio

N_LAYERS, N_SAMPLES, HIDDEN = 3, 5, 8


def _capture(seed=0):
    rng = np.random.default_rng(seed)
    acts = rng.normal(size=(N_LAYERS, N_SAMPLES, HIDDEN)).astype(np.float32)
    ids = [f"s{j}" for j in (3, 0, 4, 1, 2)]  # not sorted: the files keep the order
    metadata = [{"id": sid, "type": "bound", "shape": "cube", "color": f"c{j}"}
                for j, sid in enumerate(ids)]
    return acts, ids, metadata


def _assert_equal(got, acts, ids, metadata):
    assert list(got) == ids
    for j, sid in enumerate(ids):
        assert got[sid]["metadata"] == metadata[j]
        assert list(got[sid]["activations"]) == [f"layer_{i}" for i in range(N_LAYERS)]
        for i in range(N_LAYERS):
            vec = got[sid]["activations"][f"layer_{i}"]
            assert vec.dtype == np.float64
            np.testing.assert_array_equal(vec, acts[i, j])


@pytest.mark.parametrize("ext", ["npz", "pt"])
@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio), (tio, tio)],
                         ids=["port_to_tdax", "tdax_to_port", "port_to_port"])
def test_save_activations_reads_back_across_packages(tmp_path, ext, writer, reader):
    acts, ids, metadata = _capture()
    path = str(tmp_path / f"acts.{ext}")
    writer.save_activations(path, acts, ids, metadata)
    _assert_equal(reader.load_activations(path), acts, ids, metadata)


def test_npz_path_writes_the_columnar_npz(tmp_path):
    """An ``.npz`` path gets a real zip with tdax's three members, not a
    torch archive under an ``.npz`` name."""
    acts, ids, metadata = _capture(1)
    path = str(tmp_path / "x.npz")
    tio.save_activations(path, acts, ids, metadata)
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["activations.npy", "metadata_json.npy",
                                        "sample_ids.npy"]
    got, got_ids, got_md = tio.load_activations_npz(path)
    np.testing.assert_array_equal(got, acts)
    assert got_ids == ids and got_md == metadata


def test_pt_holds_one_tensor_per_sample_and_layer(tmp_path):
    acts, ids, metadata = _capture(2)
    path = str(tmp_path / "x.pt")
    tio.save_activations(path, acts, ids, metadata)
    raw = torch.load(path, weights_only=False)
    vec = raw[ids[1]]["activations"]["layer_2"]
    assert isinstance(vec, torch.Tensor) and vec.dtype == torch.float32
    assert vec.untyped_storage().nbytes() == HIDDEN * 4  # a copy, not a view of the capture
    np.testing.assert_array_equal(vec.numpy(), acts[2, 1])


def test_save_activations_pt_round_trips(tmp_path):
    """The reference's nested dict, with numpy vectors and tensors mixed,
    round-trips through the port and reads the same in tdax."""
    acts, ids, metadata = _capture(3)
    results = {sid: {"metadata": metadata[j],
                     "activations": {f"layer_{i}": (torch.from_numpy(acts[i, j].copy()) if i % 2
                                                    else acts[i, j])
                                     for i in range(N_LAYERS)}}
               for j, sid in enumerate(ids)}
    path = str(tmp_path / "nested.pt")
    tio.save_activations_pt(path, results)
    raw = torch.load(path, weights_only=False)
    assert all(isinstance(v, torch.Tensor) for e in raw.values() for v in e["activations"].values())
    for load in (tio.load_activations, tio.load_activations_pt, jio.load_activations):
        _assert_equal(load(path), acts, ids, metadata)
    jpath = str(tmp_path / "nested_tdax.pt")
    jio.save_activations_pt(jpath, results)
    _assert_equal(tio.load_activations(jpath), acts, ids, metadata)


def test_extract_writes_the_pt_and_the_npz_once_each(tmp_path, monkeypatch):
    """extract_activations with a ``.pt`` output writes that file through
    ``save_activations`` and its ``.npz`` sibling through
    ``save_activations_npz``, once each, each in its own format."""
    import tdax_torch.pipeline.extract as ex
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.config import QwenVLConfig

    calls = []
    for name in ("save_activations", "save_activations_npz"):
        orig = getattr(ex, name)
        monkeypatch.setattr(ex, name, lambda path, *a, _o=orig, _n=name: (calls.append((_n, path)),
                                                                          _o(path, *a)))
    md = generate_dataset(DatasetConfig(data_dir=str(tmp_path / "d")))[:3]
    out = str(tmp_path / "acts.pt")
    ex.extract_activations(md, out, QwenVLConfig.tiny(dtype="float32"),
                           ExtractConfig(batch_size=2), device="cpu", verbose=False)
    npz = str(tmp_path / "acts.npz")
    assert calls == [("save_activations", out), ("save_activations_npz", npz)]
    assert zipfile.is_zipfile(npz) and zipfile.is_zipfile(out)  # torch's archive is a zip too
    with zipfile.ZipFile(npz) as z:
        assert "activations.npy" in z.namelist()
    a, b = tio.load_activations(out), jio.load_activations(npz)
    assert list(a) == list(b) == [m["id"] for m in md]
