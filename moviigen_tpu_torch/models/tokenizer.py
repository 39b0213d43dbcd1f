"""Tokenizer wrapper for the umT5 text encoder.

The port's own copy of ``moviigen_tpu/models/tokenizer.py`` (same
cleaning, padding and fallback): ``HuggingfaceTokenizer`` with
whitespace/canonicalize cleaning and pad-to-max_length (``transformers``
is imported lazily), and a deterministic hash tokenizer for smoke runs
where no tokenizer assets exist. ftfy is optional; without it
``basic_clean`` only unescapes HTML.
"""

from __future__ import annotations

import html
import re
import string
from typing import Optional, Tuple

import numpy as np


def basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str, keep_punctuation_exact_string=None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class HuggingfaceTokenizer:
    """ref tokenizers.py:37-82 — AutoTokenizer + cleaning + fixed-length
    padding; returns numpy ids/mask."""

    def __init__(self, name: str, seq_len: Optional[int] = None,
                 clean: Optional[str] = None, **kwargs):
        self.name = name
        self.seq_len = seq_len
        self.clean = clean

        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def __call__(self, sequence, **kwargs
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return_mask = kwargs.pop("return_mask", False)
        _kwargs = {"return_tensors": "np"}
        if self.seq_len is not None:
            _kwargs.update({
                "padding": "max_length",
                "truncation": True,
                "max_length": self.seq_len,
            })
        _kwargs.update(**kwargs)

        if isinstance(sequence, str):
            sequence = [sequence]
        if self.clean:
            sequence = [self._clean(u) for u in sequence]

        ids = self.tokenizer(sequence, **_kwargs)
        if return_mask:
            return np.asarray(ids.input_ids), np.asarray(ids.attention_mask)
        return np.asarray(ids.input_ids), None

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text


class HashTokenizer:
    """Deterministic offline fallback: stable word-hash ids.

    Not a linguistic tokenizer — used only for random-weight smoke tests
    where no tokenizer assets exist (zero-egress environments)."""

    def __init__(self, seq_len: int = 512, vocab_size: int = 256384):
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def __call__(self, sequence, return_mask: bool = False, **kwargs):
        if isinstance(sequence, str):
            sequence = [sequence]
        ids = np.ones((len(sequence), self.seq_len), np.int32)  # pad id 1
        mask = np.zeros((len(sequence), self.seq_len), np.int32)
        for b, text in enumerate(sequence):
            words = whitespace_clean(basic_clean(text)).split(" ")
            toks = [(hash(w) % (self.vocab_size - 2)) + 2 for w in words]
            toks = toks[: self.seq_len - 1] + [2]  # eos-ish terminator
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1
        return (ids, mask) if return_mask else (ids, None)


def load_tokenizer(name_or_path: str, seq_len: int,
                   clean: str = "whitespace",
                   vocab_size: int = 256384):
    """HF tokenizer if assets resolve locally, else the hash fallback
    (bounded to the model's vocab)."""
    try:
        return HuggingfaceTokenizer(
            name=name_or_path, seq_len=seq_len, clean=clean,
            local_files_only=True)
    except Exception:
        import logging

        logging.warning(
            "tokenizer assets for %r unavailable; using deterministic "
            "hash fallback (smoke-test mode)", name_or_path)
        return HashTokenizer(seq_len=seq_len, vocab_size=vocab_size)
