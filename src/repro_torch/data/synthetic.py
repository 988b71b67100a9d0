"""Synthetic extreme-classification and language-model data (counterpart
of ``repro.data.synthetic``'s ``xc_dataset`` and ``lm_dataset``; numpy
only, so the same seed gives the same arrays in both packages)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["XCData", "xc_dataset", "lm_dataset"]


class XCData(NamedTuple):
    x: np.ndarray        # int32 [n, max_in]  BoW token ids, -1 pad
    labels: np.ndarray   # int32 [n, max_labels], -1 pad
    n_topics: int


def xc_dataset(seed: int, n_samples: int, input_dim: int, output_dim: int,
               n_topics: int = 64, max_in: int = 32, max_labels: int = 4,
               label_skew: float = 1.2, sig_tokens: int = 6,
               noise_frac: float = 0.35) -> XCData:
    """Topic-planted extreme classification.

    Topics own slices of the input vocabulary and of the label space
    (zipf-popular); each label carries ``sig_tokens`` signature tokens from
    its topic's slice.  A sample = signature tokens of its
    1..max_labels/2 labels + topic noise tokens.
    """
    rng = np.random.default_rng(seed)
    tok_topic = rng.integers(0, n_topics, size=input_dim)      # token->topic
    lab_topic = rng.integers(0, n_topics, size=output_dim)     # label->topic
    tok_by_topic = [np.where(tok_topic == t)[0] for t in range(n_topics)]
    lab_by_topic = [np.where(lab_topic == t)[0] for t in range(n_topics)]
    sig = np.zeros((output_dim, sig_tokens), np.int64)
    for j in range(output_dim):
        pool = tok_by_topic[lab_topic[j]]
        if len(pool) == 0:
            pool = np.arange(input_dim)
        sig[j] = pool[rng.integers(0, len(pool), size=sig_tokens)]
    pop = (1.0 / np.arange(1, n_topics + 1) ** label_skew)
    pop /= pop.sum()

    x = np.full((n_samples, max_in), -1, np.int32)
    y = np.full((n_samples, max_labels), -1, np.int32)
    n_sig = max(1, int(max_in * (1 - noise_frac)))
    for i in range(n_samples):
        t = rng.choice(n_topics, p=pop)
        pool_l = lab_by_topic[t]
        if len(pool_l) == 0:
            pool_l = np.arange(output_dim)
        k = rng.integers(1, max(max_labels // 2, 1) + 1)
        labs = np.unique(pool_l[rng.integers(0, len(pool_l), size=k)])
        toks = sig[labs].reshape(-1)
        toks = toks[rng.permutation(len(toks))][:n_sig]
        pool_t = tok_by_topic[t]
        if len(pool_t):
            noise = pool_t[rng.integers(0, len(pool_t),
                                        size=max_in - len(toks))]
            toks = np.concatenate([toks, noise])
        x[i, :len(toks[:max_in])] = toks[:max_in]
        y[i, :len(labs)] = labs[:max_labels]
    return XCData(x, y, n_topics)


def lm_dataset(seed: int, n_tokens: int, vocab: int, seq_len: int,
               n_topics: int = 32) -> np.ndarray:
    """Topic-switching zipf LM stream -> [n_seqs, seq_len] int32."""
    rng = np.random.default_rng(seed)
    tok_topic = rng.integers(0, n_topics, size=vocab)
    by_topic = [np.where(tok_topic == t)[0] for t in range(n_topics)]
    n_seqs = n_tokens // seq_len
    out = np.zeros((n_seqs, seq_len), np.int32)
    for i in range(n_seqs):
        t = rng.integers(0, n_topics)
        pos = 0
        while pos < seq_len:
            run = int(rng.integers(8, 32))
            pool = by_topic[t]
            ranks = rng.zipf(1.3, size=run) % max(len(pool), 1)
            out[i, pos:pos + run] = pool[ranks][: seq_len - pos]
            pos += run
            if rng.random() < 0.2:
                t = rng.integers(0, n_topics)
    return out
