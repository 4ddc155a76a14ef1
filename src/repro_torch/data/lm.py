"""Synthetic LM data pipeline: deterministic, shardable token streams.

Token sequences follow a Zipfian unigram + Markov bigram mixture so the loss
actually *decreases* during the example runs (pure uniform noise has no
learnable signal).  Batches are produced host-side (numpy), as a real
per-host data loader would; the port's copy of the reference's
``data/lm.py``, whose batches it equals bit for bit for a seed.
"""
from __future__ import annotations

import numpy as np


class LMStream:
    def __init__(self, vocab: int, seq_len: int, batch: int,
                 microbatches: int = 1, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.micro = microbatches
        self.rng = np.random.default_rng(seed)
        # Zipf unigram distribution
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.p = (1.0 / ranks) / np.sum(1.0 / ranks)
        # deterministic "grammar": token t is followed by (t*7+3)%vocab wp .5
        self.next_tok = (np.arange(vocab) * 7 + 3) % vocab

    def __iter__(self):
        return self

    def __next__(self):
        shape = ((self.micro, self.batch // self.micro, self.seq_len + 1)
                 if self.micro > 1 else (self.batch, self.seq_len + 1))
        toks = self.rng.choice(self.vocab, size=shape, p=self.p)
        follow = self.rng.random(shape[:-1] + (self.seq_len,)) < 0.5
        toks = toks.astype(np.int32)
        toks[..., 1:] = np.where(follow, self.next_tok[toks[..., :-1]],
                                 toks[..., 1:])
        return {"tokens": toks}
