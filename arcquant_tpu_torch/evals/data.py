"""Calibration and evaluation token streams (counterpart of
``arcquant_tpu/evals/data.py``, numpy only).

The text datasets (wikitext2, ptb, c4, pile, humaneval) come from a
local jsonl mirror under ``ARC_DATA_DIR`` or from HF ``datasets``
(imported only then); ``synthetic`` is a deterministic Zipf + Markov
token stream, the same stream as the JAX package's for the same
arguments, so perplexity is reproducible without any download.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

DATASETS = ("wikitext2", "ptb", "c4", "pile", "humaneval", "synthetic")


def synthetic_stream(vocab_size: int, n_tokens: int,
                     seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-language token stream (int32 [n_tokens]): a
    Zipf unigram prior mixed with a sparse first-order Markov kernel, so
    a real LM reaches a non-trivial, quantization-sensitive
    perplexity."""
    rng = np.random.default_rng(seed)
    v = vocab_size
    unigram = 1.0 / np.arange(1, v + 1)
    unigram /= unigram.sum()
    n_succ = min(32, v)
    succ = rng.integers(0, v, size=(v, n_succ))
    out = np.empty(n_tokens, np.int32)
    cur = int(rng.integers(0, v))
    unigram_draws = rng.choice(v, size=n_tokens, p=unigram)
    mix = rng.random(n_tokens)
    succ_pick = rng.integers(0, n_succ, size=n_tokens)
    for i in range(n_tokens):
        if mix[i] < 0.6:
            cur = int(succ[cur, succ_pick[i]])
        else:
            cur = int(unigram_draws[i])
        out[i] = cur
    return out


# dataset -> (load_dataset args, text column, joiner[, fixed split])
_HF_SPECS: Dict[str, tuple] = {
    "wikitext2": (("wikitext", "wikitext-2-raw-v1"), "text", "\n\n"),
    "ptb": (("ptb_text_only", "penn_treebank"), "sentence", " "),
    "c4": (("allenai/c4", "en"), "text", " "),
    "pile": (("monology/pile-uncopyrighted",), "text", "\n\n"),
    "humaneval": (("openai_humaneval",), "prompt", "\n\n", "test"),
}


def _local_records(dataset: str, split: str):
    """The offline mirror ARC_DATA_DIR/<dataset>.<split>.jsonl (one JSON
    record a line, the HF dataset's schema): its records, or None."""
    root = os.environ.get("ARC_DATA_DIR")
    if not root:
        return None
    path = os.path.join(root, f"{dataset}.{split}.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _hf_text_stream(dataset: str, split: str) -> str:
    """A text split joined as _HF_SPECS says: from the local mirror when
    present, else from HF `datasets` (needs its local cache or the
    network)."""
    if dataset not in _HF_SPECS:
        raise KeyError(dataset)
    spec = _HF_SPECS[dataset]
    args, column, joiner = spec[:3]
    if len(spec) > 3:
        split = spec[3]
    records = _local_records(dataset, split)
    if records is None:
        from datasets import load_dataset  # only when no mirror is given
        ds = load_dataset(*args, split=split)
        return joiner.join(ds[column])
    return joiner.join(r[column] for r in records)


def get_token_stream(dataset: str, split: str, tokenizer,
                     vocab_size: int = 32000, n_tokens: int = 2048 * 16,
                     seed: int = 0) -> np.ndarray:
    """A flat int32 token stream for perplexity or calibration.
    tokenizer: text -> list of ids, or None for 'synthetic'."""
    if dataset == "synthetic":
        return synthetic_stream(vocab_size, n_tokens, seed)
    return np.asarray(tokenizer(_hf_text_stream(dataset, split)), np.int32)


def get_calib_samples(dataset: str, tokenizer, nsamples: int = 128,
                      seqlen: int = 2048, vocab_size: int = 32000,
                      seed: int = 0) -> np.ndarray:
    """[nsamples, seqlen] int32 random windows of the train split."""
    stream = get_token_stream(
        dataset, "train", tokenizer, vocab_size,
        n_tokens=max(nsamples * seqlen * 2, 2048 * 32), seed=seed)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(stream.shape[0] - seqlen - 1, 1),
                          size=nsamples)
    return np.stack([stream[s:s + seqlen] for s in starts]).astype(np.int32)
