"""The port's ``QwenTokenizerAdapter`` and ``get_tokenizer`` against
tdax's, on ``tests/fixtures/qwen_tok_fixture`` (a trust_remote_code
tokenizer with Qwen-VL's special ids and image-span contract; see
tests/test_tokenizer_adapter.py).  Ids, spans and batch arrays must be
equal, not close.
"""

import os
import shutil

import numpy as np
import pytest

from tdax.models.qwen_vl.config import QwenVLConfig as JConfig
from tdax.models.qwen_vl.tokenizer import QwenTokenizerAdapter as JAdapter
from tdax.models.qwen_vl.tokenizer import ToyTokenizer as JToyTokenizer
from tdax.models.qwen_vl.tokenizer import batch_encode as j_batch_encode
from tdax.models.qwen_vl.tokenizer import get_tokenizer as j_get_tokenizer

from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.tokenizer import (QwenTokenizerAdapter, ToyTokenizer,
                                                 batch_encode, from_list_format,
                                                 get_tokenizer)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "qwen_tok_fixture")
CFG, JCFG = QwenVLConfig(), JConfig()  # the full config: real special ids, 256 queries
SAMPLES = [
    {"image_path": "img/a.png", "prompt": "a photo of a red cube"},
    {"image_path": "img/b.png", "prompt": "a blue sphere"},
    {"image_path": "images/grey_torus.png", "prompt": "a photo of a grey torus"},
]


@pytest.fixture(scope="module")
def adapters():
    tok, jtok = get_tokenizer(FIXTURE, CFG), j_get_tokenizer(FIXTURE, JCFG)
    assert isinstance(tok, QwenTokenizerAdapter) and isinstance(jtok, JAdapter)
    return tok, jtok


def test_adapter_ids_match_tdax(adapters):
    tok, jtok = adapters
    assert tok.pad_id == jtok.pad_id == 151643  # <|endoftext|>, not the toy's 0
    for text in ("abc", "a photo of a red cube", "", "Picture 1: x\n"):
        assert tok.encode_text(text) == jtok.encode_text(text)


@pytest.mark.parametrize("path", ["images/red_cube.png", "img/b.png"])
def test_image_span_matches_tdax(adapters, path):
    tok, jtok = adapters
    query = from_list_format([{"image": path}, {"text": "a photo of a red cube"}])
    enc, want = tok(query), jtok(query)
    assert enc == want
    (s,) = enc["image_span_starts"]
    ids = enc["input_ids"]
    assert enc["images"] == [path]
    assert ids[s - 1] == CFG.img_start_id and ids[s + CFG.visual.n_queries] == CFG.img_end_id
    assert ids[s:s + len(path)] == list(path.encode())


def test_batch_encode_matches_tdax(adapters):
    """Last-text-token index, padding with the real pad id, image rows."""
    tok, jtok = adapters
    got = batch_encode(tok, SAMPLES, CFG)
    want = j_batch_encode(jtok, SAMPLES, JCFG)
    assert set(got) == set(want)
    for key in ("input_ids", "attn_mask", "last_token_idx", "image_positions"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image_paths"] == want["image_paths"] == [s["image_path"] for s in SAMPLES]
    for j, item in enumerate(SAMPLES):
        n_real = int(got["attn_mask"][j].sum())
        assert int(got["last_token_idx"][j]) == n_real - 1
        assert (got["input_ids"][j, n_real:] == tok.pad_id).all()


def test_no_tokenizer_files_gives_the_toy_tokenizer(tmp_path):
    (tmp_path / "pytorch_model.bin").write_bytes(b"")  # a directory without tokenizer files
    for model_dir in (None, str(tmp_path), str(tmp_path / "absent")):
        tok = get_tokenizer(model_dir, CFG)
        assert isinstance(tok, ToyTokenizer)
        assert isinstance(j_get_tokenizer(model_dir, JCFG), JToyTokenizer)
        np.testing.assert_array_equal(batch_encode(tok, SAMPLES, CFG)["input_ids"],
                                      j_batch_encode(JToyTokenizer(JCFG), SAMPLES,
                                                     JCFG)["input_ids"])


def test_a_broken_tokenizer_raises_where_tdax_falls_back(tmp_path, capsys):
    """The departure: tdax prints a message and uses the byte-level
    tokenizer; the port refuses, since byte-level ids fed to real weights
    give a capture that looks valid and is wrong."""
    for f in os.listdir(FIXTURE):
        shutil.copy(os.path.join(FIXTURE, f), tmp_path / f)
    (tmp_path / "tokenizer_config.json").write_text('{"tokenizer_class": ')
    assert isinstance(j_get_tokenizer(str(tmp_path), JCFG), JToyTokenizer)
    assert "falling back to ToyTokenizer" in capsys.readouterr().out
    with pytest.raises(ValueError):
        get_tokenizer(str(tmp_path), CFG)
