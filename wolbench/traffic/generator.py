"""The one generator behind every traffic mix.  A mix is a JSON file of
parameters beside this module, found by its name (``bulk`` ->
``bulk.json``); its ``kind`` says what it makes:

* ``bulk``: a pool of BoW row batches ``[pool_batches, batch_rows,
  max_in]`` (int32 feature ids, -1 padded) that ``clients`` closed-loop
  clients send whole, each waiting for its answers before the next.
* ``sessions``: a pool of decode sessions (prompt tokens, new tokens)
  that ``clients`` closed-loop clients start one after another, over a
  server of ``slots`` streams.

Token draws follow the repository's synthetic data (topic-planted Zipf
ranks over slices of the vocabulary), vectorised.  Every size is drawn
stratified: within each block of ``clients`` sessions (or each batch of
rows) the lengths are the same evenly spread set for every seed, and the
seed only orders them, so two seeds give the same work in another order.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["HERE", "load", "rng_for", "stratified", "topic_tokens",
           "bow_pool", "session_plan", "prefill_buckets"]

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix ``name``'s parameters."""
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic mix {name!r} ({path.name} is missing)")
    return json.loads(path.read_text())


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the run's seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def stratified(lo: int, hi: int, n: int, rng: np.random.Generator
               ) -> np.ndarray:
    """``n`` integers spread evenly over ``[lo, hi]`` (the midpoints of n
    equal strata), in the order ``rng`` shuffles them."""
    span = hi - lo + 1
    vals = lo + np.floor((np.arange(n) + 0.5) * span / n).astype(np.int64)
    return rng.permutation(np.minimum(vals, hi))


def topic_tokens(rng: np.random.Generator, n_rows: int, width: int,
                 vocab: int, topics: int, zipf: float) -> np.ndarray:
    """int32 ``[n_rows, width]``: each row's topic drawn by Zipf
    popularity, its tokens Zipf ranks within that topic's slice of a
    shuffled vocabulary."""
    perm = rng.permutation(vocab)
    size = max(vocab // topics, 1)
    pop = 1.0 / np.arange(1, topics + 1) ** zipf
    topic = rng.choice(topics, size=n_rows, p=pop / pop.sum())
    ranks = (rng.zipf(zipf, size=(n_rows, width)) - 1) % size
    return perm[(topic[:, None] * size + ranks) % vocab].astype(np.int32)


def bow_pool(mix: dict, input_dim: int, max_in: int, seed: int
             ) -> np.ndarray:
    """The ``bulk`` mix's pool of row batches; each batch holds the same
    spread of feature counts over ``features`` = [lo, hi]."""
    rng = rng_for(seed, 1)
    n, rows = mix["pool_batches"], mix["batch_rows"]
    lo, hi = mix["features"]
    ids = topic_tokens(rng, n * rows, max_in, input_dim, mix["topics"],
                       mix["zipf"]).reshape(n, rows, max_in)
    counts = np.stack([stratified(lo, hi, rows, rng) for _ in range(n)])
    ids[np.arange(max_in)[None, None, :] >= counts[..., None]] = -1
    return ids


def session_plan(mix: dict, vocab: int, seed: int
                 ) -> list[tuple[np.ndarray, int]]:
    """The ``sessions`` mix's pool: ``(prompt int32 [p], new tokens)`` in
    the order clients start them.  The first wave (one session a
    client) joins a stream already under way: it asks for a stratified
    share of its drawn length, so completions spread from the start."""
    rng = rng_for(seed, 2)
    n, block = mix["pool_sessions"], mix["clients"]
    p_lo, p_hi = mix["prompt_tokens"]
    o_lo, o_hi = mix["output_tokens"]
    plens = np.concatenate([stratified(p_lo, p_hi, block, rng)
                            for _ in range(-(-n // block))])[:n]
    outs = np.concatenate([stratified(o_lo, o_hi, block, rng)
                           for _ in range(-(-n // block))])[:n]
    if mix.get("first_wave_remainder"):
        frac = (rng.permutation(block) + 0.5) / block
        outs[:block] = np.maximum(1, np.floor(frac * outs[:block]))
    toks = topic_tokens(rng, n, p_hi, vocab, mix["topics"], mix["zipf"])
    return [(toks[i, :plens[i]].copy(), int(outs[i])) for i in range(n)]


def prefill_buckets(lo: int, hi: int, floor: int = 8) -> list[int]:
    """The power-of-two prompt widths that prompts of ``lo``..``hi``
    tokens are padded to (the decode scheduler's prefill buckets)."""
    out, b = [], max(floor, 1 << max(lo - 1, 0).bit_length())
    while True:
        out.append(b)
        if b >= hi:
            return out
        b *= 2
