"""The port's offline tokenizer, frozen here (``moviigen_tpu_torch/models/
tokenizer.py::HashTokenizer`` and its cleaning, commit 503dac0): each
whitespace-separated word of the cleaned prompt becomes
``hash(word) % (vocab − 2) + 2``, then an end id 2, padded with 1 to
``seq_len``. Python salts ``hash`` per process unless ``PYTHONHASHSEED``
is set: the harness runs with it fixed, so that one seed gives one set of
ids in every run.
"""

from __future__ import annotations

import html
import re

import numpy as np


def _clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text).strip()


def tokenize(texts, seq_len: int, vocab_size: int):
    """(ids, mask) [len(texts), seq_len] int64."""
    ids = np.ones((len(texts), seq_len), np.int64)
    mask = np.zeros((len(texts), seq_len), np.int64)
    for b, text in enumerate(texts):
        toks = [hash(w) % (vocab_size - 2) + 2
                for w in _clean(text).split(" ")]
        toks = toks[:seq_len - 1] + [2]
        ids[b, :len(toks)] = toks
        mask[b, :len(toks)] = 1
    return ids, mask
