"""Synthetic, learnable datasets, as :mod:`repro.data.synthetic`: the same
tables and JAX's key stream, so a key gives the reference's batch bit
for bit (images within a few f32 ulps of its normals).

* ``BigramLM``: token sequences from a fixed random bigram chain.
* ``GaussianMixtureImages``: CIFAR-like (32x32x3) class-conditional
  Gaussian patterns.

Both are pure functions of (seed, key), so a restored checkpoint replays
the same stream.  Batches are drawn on the host (int64 tokens and
labels, f32 images); :func:`repro_torch.data.pipeline.place_batch` moves
them to the device.

The bigram table is a dense ``vocab x vocab`` array, as the reference
draws it: 184.7 GB in f64 at qwen2-1.5b's vocab of 151,936 and 20.2 GB
at gpt2's 50,257.  Those vocabularies run on the smoke configs (the
launch driver's ``--smoke``) or on seeded tokens.  The port keeps the
table across calls (the values do not change), where the reference
redraws it on every batch.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import prng as R


@functools.lru_cache(maxsize=2)
def _bigram_table(vocab: int, seed: int, temperature: float):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(vocab, vocab)) / temperature
    return torch.from_numpy(logits.astype(np.float32))


@dataclasses.dataclass(frozen=True)
class BigramLM:
    vocab: int
    seq_len: int
    seed: int = 0
    temperature: float = 0.5

    def _table(self) -> torch.Tensor:
        return _bigram_table(self.vocab, self.seed, self.temperature)

    def batch(self, key, batch_size: int):
        """``{"inputs", "labels"}``, each (batch_size, seq_len - 1).  Row
        ``b`` is the reference's ``sample_seq(split(key, B)[b])``: the
        first token ``randint`` under the row key's first split, token
        ``t + 1`` a categorical draw from the table row of token ``t``
        under ``fold_in`` of its second split by ``t``.  One draw per
        position covers every row (``prng.categorical_rows``)."""
        table = self._table()
        rows = R.split(key, batch_size)
        k0 = R.fold_in_many(rows, np.zeros(batch_size, np.int64))
        k1 = R.fold_in_many(rows, np.ones(batch_size, np.int64))
        tok = torch.stack([R.randint(k, (), 0, self.vocab) for k in k0])
        toks = [tok]
        for t in range(self.seq_len - 1):
            keys = R.fold_in_many(k1, np.full(batch_size, t, np.int64))
            tok = R.categorical_rows(keys, table[tok])
            toks.append(tok)
        toks = torch.stack(toks, dim=1)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class GaussianMixtureImages:
    classes: int = 10
    hw: int = 32
    noise: float = 0.6
    seed: int = 0

    def _means(self) -> torch.Tensor:
        rng = np.random.default_rng(self.seed)
        return torch.from_numpy(rng.normal(
            size=(self.classes, self.hw, self.hw, 3)).astype(np.float32))

    def batch(self, key, batch_size: int, class_probs=None):
        """``{"inputs": (B, hw, hw, 3) f32, "labels": (B,)}``: labels
        ``randint`` (or a categorical draw from ``class_probs``) under
        ``split(key)[0]``, images the class mean plus ``noise`` times
        normals under ``split(key)[1]``."""
        k0, k1 = R.split(key, 2)
        if class_probs is None:
            labels = R.randint(k0, (batch_size,), 0, self.classes)
        else:
            probs = torch.as_tensor(class_probs, dtype=torch.float32)
            labels = R.categorical(k0, torch.log(torch.clamp(probs,
                                                             min=1e-9)),
                                   shape=(batch_size,))
        z = R.normal(k1, (batch_size, self.hw, self.hw, 3))
        x = self._means()[labels] + R._f32(self.noise) * z
        return {"inputs": x, "labels": labels}
