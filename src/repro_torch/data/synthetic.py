"""Synthetic data (counterpart of ``repro.data.synthetic``): extreme
classification, a language-model stream, Criteo-like CTR rows, BERT4Rec
item sequences and homophilous graphs.  numpy only, so the same seed
gives the same arrays in both packages."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["XCData", "xc_dataset", "lm_dataset", "ctr_dataset",
           "seqrec_dataset", "graph_dataset", "to_csr"]


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


def ctr_dataset(seed: int, n: int, n_fields: int, vocab_per_field: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Criteo-like CTR with a planted logistic ground truth.

    Returns (ids [n, n_fields] field-local int32, labels [n] {0,1}).
    """
    rng = np.random.default_rng(seed)
    # zipf-distributed ids (realistic table access pattern)
    ids = (rng.zipf(1.2, size=(n, n_fields)) - 1) % vocab_per_field
    w = rng.normal(0, 1.0, size=(n_fields, 16))
    emb = rng.normal(0, 0.3, size=(n_fields, vocab_per_field, 2))
    # ground truth = sum of per-field effects + one pairwise interaction
    # (the reference also builds an unused take_along_axis array here,
    # which raises IndexError when vocab_per_field > n_fields; it draws
    # nothing, so leaving it out keeps every array bit for bit)
    s = emb[np.arange(n_fields)[None, :], ids, 0].sum(1)
    s += emb[0, ids[:, 0], 1] * emb[1, ids[:, 1], 1] * 3.0
    p = 1 / (1 + np.exp(-(s - s.mean()) / (s.std() + 1e-6)))
    labels = (rng.random(n) < p).astype(np.int32)
    return ids.astype(np.int32), labels


def seqrec_dataset(seed: int, n_users: int, seq_len: int, n_items: int,
                   n_clusters: int = 50, mask_prob: float = 0.2
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Cluster-random-walk item sequences + cloze masking for BERT4Rec.

    Returns (seq [n, S] with masked positions id-preserved, labels [n, S]
    with -1 at unmasked positions).
    """
    rng = np.random.default_rng(seed)
    item_cluster = rng.integers(0, n_clusters, size=n_items)
    by_cluster = [np.where(item_cluster == c)[0] for c in range(n_clusters)]
    seq = np.zeros((n_users, seq_len), np.int32)
    for i in range(n_users):
        c = rng.integers(0, n_clusters)
        for s in range(seq_len):
            if rng.random() < 0.1:
                c = rng.integers(0, n_clusters)
            pool = by_cluster[c]
            seq[i, s] = pool[rng.integers(0, len(pool))] if len(pool) else 0
    mask = rng.random((n_users, seq_len)) < mask_prob
    labels = np.where(mask, seq, -1).astype(np.int32)
    return seq, labels


def graph_dataset(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                  n_classes: int, homophily: float = 0.8
                  ) -> dict[str, np.ndarray]:
    """Homophilous random graph: nodes get classes; edges prefer same-class
    endpoints; features = class centroid + noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    cent = rng.normal(0, 1, size=(n_classes, d_feat))
    x = cent[labels] + rng.normal(0, 0.8, size=(n_nodes, d_feat))
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = np.where(rng.random(n_edges) < homophily,
                   # same-class partner: random node then snap to a same-class one
                   rng.permutation(n_nodes)[src % n_nodes],
                   rng.integers(0, n_nodes, size=n_edges))
    same = rng.random(n_edges) < homophily
    # resample dst for homophilous edges from the same class as src
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    dst_h = np.array([by_class[labels[s]][rng.integers(len(by_class[labels[s]]))]
                      for s in src[same]]) if same.any() else np.array([], np.int64)
    dst[same] = dst_h
    train_mask = rng.random(n_nodes) < 0.6
    return {
        "x": x.astype(np.float32),
        "edges": np.stack([src, dst], 1).astype(np.int32),
        "labels": labels.astype(np.int32),
        "train_labels": np.where(train_mask, labels, -1).astype(np.int32),
    }


def to_csr(edges: np.ndarray, n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Edge list -> (indptr [N+1], indices [E]) for the neighbor sampler."""
    order = np.argsort(edges[:, 1], kind="stable")
    sorted_dst = edges[order, 1]
    indices = edges[order, 0].astype(np.int32)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, sorted_dst + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr.astype(np.int32), indices
