"""Multimodal tokenization for Qwen-VL (port of
``tdax/models/qwen_vl/tokenizer.py``).

  * ``from_list_format([{image}, {text}])`` -> the Qwen-VL query string
    ``Picture {i}: <img>path</img>\\n{text}``;
  * encoding that query to ids where the ``<img>...</img>`` span becomes
    img_start + n_queries x img_pad + img_end;
  * the last-TEXT-token locator: substring-match the text-only ids
    inside the full sequence, fallback index -2.

Backends: the real Qwen tokenizer of a checkpoint directory through
Hugging Face ``transformers`` (``trust_remote_code``; imported only when
a directory holds a ``tokenizer_config.json``), or the self-contained
byte-level ``ToyTokenizer`` that goes with random weights.
"""

from __future__ import annotations

import os
import re

import numpy as np

from tdax_torch.models.qwen_vl.config import QwenVLConfig

IMG_TAG_RE = re.compile(r"<img>(.*?)</img>")


def from_list_format(items: list[dict]) -> str:
    """Qwen-VL list format -> query string (tokenization_qwen contract)."""
    parts = []
    img_idx = 0
    for item in items:
        if "image" in item:
            img_idx += 1
            parts.append(f"Picture {img_idx}: <img>{item['image']}</img>\n")
        elif "text" in item:
            parts.append(item["text"])
        else:
            raise ValueError(f"unsupported item: {item}")
    return "".join(parts)


def find_last_text_token_index(full_ids: list[int], text_ids: list[int]) -> int:
    """Index of the last text token, or -2 when not found."""
    n = len(text_ids)
    if n == 0:
        return -2
    for i in range(len(full_ids) - n + 1):
        if full_ids[i:i + n] == text_ids:
            return i + n - 1
    return -2


class ToyTokenizer:
    """Deterministic byte-level tokenizer with Qwen-VL image-span
    semantics.  Ids: 0 = pad, 1..256 = bytes, then the special ids of
    the model config."""

    def __init__(self, cfg: QwenVLConfig):
        self.cfg = cfg
        self.pad_id = 0

    def encode_text(self, text: str) -> list[int]:
        return [1 + b for b in text.encode("utf-8")]

    def __call__(self, query: str) -> dict:
        """Encode a from_list_format query: image tags expand to the
        img_start/pad/end span; returns ids + image paths + span starts."""
        cfg = self.cfg
        ids: list[int] = []
        images: list[str] = []
        spans: list[int] = []
        pos = 0
        for m in IMG_TAG_RE.finditer(query):
            ids.extend(self.encode_text(query[pos:m.start()]))
            ids.append(cfg.img_start_id % cfg.vocab_size)
            spans.append(len(ids))
            images.append(m.group(1))
            ids.extend([cfg.img_pad_id % cfg.vocab_size] * cfg.visual.n_queries)
            ids.append(cfg.img_end_id % cfg.vocab_size)
            pos = m.end()
        ids.extend(self.encode_text(query[pos:]))
        return {"input_ids": ids, "images": images, "image_span_starts": spans}


class QwenTokenizerAdapter:
    """Wraps the real HF Qwen-VL tokenizer (trust_remote_code) behind the
    same interface as ToyTokenizer."""

    def __init__(self, model_dir: str, cfg: QwenVLConfig):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(model_dir, trust_remote_code=True,
                                                 local_files_only=True)
        self.cfg = cfg
        self.pad_id = self.tok.pad_token_id or 0

    def encode_text(self, text: str) -> list[int]:
        return self.tok(text, add_special_tokens=False).input_ids

    def __call__(self, query: str) -> dict:
        ids = self.tok(query).input_ids
        spans = [i + 1 for i, t in enumerate(ids) if t == self.cfg.img_start_id]
        images = IMG_TAG_RE.findall(query)
        return {"input_ids": ids, "images": images, "image_span_starts": spans}


def get_tokenizer(model_dir: str | None, cfg: QwenVLConfig):
    """The checkpoint's own tokenizer when ``model_dir`` holds a
    ``tokenizer_config.json``, the ``ToyTokenizer`` otherwise.

    Where tdax prints a message and falls back to the toy tokenizer when
    the real one fails to load, this raises: byte-level ids fed to real
    weights give a capture that looks valid and is wrong."""
    if model_dir and os.path.isfile(os.path.join(model_dir, "tokenizer_config.json")):
        return QwenTokenizerAdapter(model_dir, cfg)
    return ToyTokenizer(cfg)


def batch_encode(tokenizer, samples: list[dict], cfg: QwenVLConfig,
                 max_len: int | None = None) -> dict:
    """Encode metadata samples into right-padded int32 batch arrays.

    Per sample: from_list_format([{image}, {text}]) then the last-text-
    token search (fallback: second-to-last token)."""
    encoded = []
    for item in samples:
        query = from_list_format([
            {"image": item["image_path"]},
            {"text": item["prompt"]},
        ])
        enc = tokenizer(query)
        text_ids = tokenizer.encode_text(item["prompt"])
        last_idx = find_last_text_token_index(enc["input_ids"], text_ids)
        if last_idx == -2:
            last_idx = len(enc["input_ids"]) - 2
        encoded.append((enc, last_idx, item))

    longest = max(len(e["input_ids"]) for e, _, _ in encoded)
    max_len = max_len or longest
    if longest > max_len:
        raise ValueError(f"sequence length {longest} exceeds max_len {max_len}")

    b = len(encoded)
    nq = cfg.visual.n_queries
    input_ids = np.full((b, max_len), tokenizer.pad_id, dtype=np.int32)
    attn_mask = np.zeros((b, max_len), dtype=np.int32)
    last_token_idx = np.zeros((b,), dtype=np.int32)
    image_positions = np.full((b, nq), -1, dtype=np.int32)
    image_paths: list[str | None] = []
    for j, (enc, last_idx, item) in enumerate(encoded):
        ids = enc["input_ids"]
        input_ids[j, :len(ids)] = ids
        attn_mask[j, :len(ids)] = 1
        last_token_idx[j] = last_idx
        if enc["image_span_starts"]:
            s = enc["image_span_starts"][0]
            image_positions[j] = np.arange(s, s + nq)
            image_paths.append(enc["images"][0])
        else:
            image_paths.append(None)
    return {
        "input_ids": input_ids,
        "attn_mask": attn_mask,
        "last_token_idx": last_token_idx,
        "image_positions": image_positions,
        "image_paths": image_paths,
    }
