"""Deterministic synthetic-LM data pipeline (port of
``repro.data.pipeline``).

Stateless by construction: a batch is a pure function of ``(seed, step,
shard)``, so a restarted run regenerates exactly the batches it owned and
a checkpoint needs no loader state beyond ``step``.  The construction is
the JAX package's: tokens drawn from a Zipf(``zipf_alpha``) unigram table,
then a copy overlay (every position whose index modulo ``copy_period`` is
at least half of it repeats the token ``copy_period / 2`` earlier), and
``labels`` the tokens shifted by one, so the loss can fall.

Where the port differs: the random stream is its own.  Each row of the
global batch draws from a CPU ``torch.Generator`` seeded from ``(seed,
step, row)`` (numpy's ``SeedSequence`` mixes the three), by inverting the
unigram CDF at uniform draws; a shard is a slice of rows, so the shards of
one step tile the global batch whatever their number.  It does not
reproduce JAX's threefry stream: its batches differ from the JAX
package's, and a parity test feeds both packages one numpy batch.  The
batch is made on the CPU and then moved to ``device``, so the CPU and the
card see the same tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    copy_period: int = 64      # structure: token repeats every period
    zipf_alpha: float = 1.1


class SyntheticLM:
    """Deterministic synthetic token stream, shardable by (step, shard)."""

    def __init__(self, cfg: DataConfig, n_shards: int = 1, device="cpu"):
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {n_shards} shards")
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard_batch = cfg.global_batch // n_shards
        self.device = torch.device(device)
        # Zipfian unigram table (host-side, deterministic)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_alpha
        self.probs = torch.as_tensor(probs / probs.sum(), dtype=torch.float32)
        self._cdf = torch.as_tensor(np.cumsum(probs / probs.sum()))

    def _row(self, step: int, row: int) -> torch.Tensor:
        """Row ``row`` of the global batch of ``step``: seq_len + 1 tokens
        before the overlay, int64."""
        seed = np.random.SeedSequence(
            [self.cfg.seed, step, row]).generate_state(1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))
        u = torch.rand(self.cfg.seq_len + 1, generator=gen,
                       dtype=torch.float64)
        return torch.searchsorted(self._cdf, u).clamp(max=self.cfg.vocab - 1)

    def batch(self, step: int, shard: int = 0):
        """{"tokens", "labels"}, each (shard_batch, seq_len) int32 on the
        pipeline's device, for one shard of one step; a pure function."""
        cfg = self.cfg
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} of {self.n_shards}")
        r0 = shard * self.shard_batch
        base = torch.stack([self._row(step, r)
                            for r in range(r0, r0 + self.shard_batch)])
        # overlay a copy pattern: the second half of every period repeats
        # the token half a period earlier (learnable structure)
        half = cfg.copy_period // 2
        pos = torch.arange(cfg.seq_len + 1)
        use_copy = (pos % cfg.copy_period) >= half
        shifted = torch.roll(base, half, dims=1)
        toks = torch.where(use_copy[None, :], shifted, base).to(torch.int32)
        toks = toks.to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_specs(vocab: int, seq_len: int, global_batch: int):
    """Shape and dtype stand-ins for one global batch: int32 tensors on
    the ``meta`` device."""
    spec = torch.empty((global_batch, seq_len), dtype=torch.int32,
                       device="meta")
    return {"tokens": spec, "labels": spec}
