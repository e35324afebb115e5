"""Semi-balance batch sampling — labeled:unlabeled mixing per batch.

Behavior parity with `DistributedGroupSemiBalanceSampler`
(`detr_ssod/datasets/samplers/semi_sampler.py:11-199`): every batch mixes
`sample_ratio` labeled:unlabeled items (default [1, 4],
`base_dino_detr_ssod_coco.py:221-229`), items come from aspect-ratio
groups (dataset `flag`), the epoch length is fixed (`epoch_length=7330`),
ordering is epoch-seeded and deterministic, and each rank/host takes a
strided shard.

The port's own copy of `semi_detr_tpu/data/sampler.py`: the same seed
gives the same index stream. The sampler yields (sup_indices,
unsup_indices, flag) per step; the loader builds one sup batch and one
two-view unsup batch from them. There is no torch Sampler object, just a
deterministic index stream any process can compute for its shard.

Sharding: `sample_ratio`/`samples_per_batch` are per process (the
reference's per-GPU semantics); each step draws num_shards * batch
indices from one seeded stream and shard `shard_id` takes its contiguous
slice: every process sees the same step with disjoint data, the
reference's rank sharding (`semi_sampler.py:185-187`).
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class SemiBalanceSampler:
    def __init__(self, num_sup: int, num_unsup: int,
                 sup_flags: Sequence[int], unsup_flags: Sequence[int],
                 samples_per_batch: int = 5,
                 sample_ratio: Tuple[int, int] = (1, 4),
                 epoch_length: int = 7330,
                 # the reference samples the per-batch sup/unsup split
                 # from a multinomial (`semi_sampler.py:118-132`,
                 # by_prob=True); the default is the exact ratio (same
                 # expectation, fixed batch shapes), as in the JAX
                 # package; by_prob=True reproduces the reference's
                 # jitter.
                 by_prob: bool = False,
                 seed: int = 0,
                 num_shards: int = 1, shard_id: int = 0):
        assert sum(sample_ratio) == samples_per_batch or by_prob, (
            "ratio must fill the batch unless sampling by probability")
        if num_sup <= 0 or num_unsup <= 0:
            raise ValueError(
                f"SemiBalanceSampler needs non-empty datasets "
                f"(sup={num_sup}, unsup={num_unsup}); an empty stream "
                f"would spin forever")
        self.num_sup = num_sup
        self.num_unsup = num_unsup
        self.sup_flags = np.asarray(sup_flags)
        self.unsup_flags = np.asarray(unsup_flags)
        self.samples_per_batch = samples_per_batch
        self.sample_ratio = sample_ratio
        self.epoch_length = epoch_length
        self.by_prob = by_prob
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id

    def epoch(self, epoch: int
              ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yields (sup_idx, unsup_idx, flag) per batch for this shard.

        Every batch is aspect-ratio homogeneous (mmdet group-sampler
        semantics via the dataset `flag`): all its images share one
        orientation, so the host pipeline can pick ONE static bucket per
        step — landscape batches pad to (H, W), portrait to (W, H)."""
        rng = np.random.default_rng(self.seed + epoch)
        streams = {}
        n_flagged = {}
        for f in (0, 1):
            sup_ids = np.nonzero(self.sup_flags == f)[0]
            unsup_ids = np.nonzero(self.unsup_flags == f)[0]
            n_flagged[f] = (len(sup_ids), len(unsup_ids))
            streams[f] = (self._infinite(rng, sup_ids),
                          self._infinite(rng, unsup_ids))
        # flags usable only if BOTH datasets have images of it: every
        # batch must be orientation-pure (one static bucket per step —
        # a mixed batch would crash pack()'s fit assert for whichever
        # image doesn't match the flag's bucket orientation)
        usable = [f for f in (0, 1) if min(n_flagged[f]) > 0]
        if not usable:
            raise ValueError(
                "sup/unsup datasets share no aspect-ratio group "
                f"(sup landscape/portrait counts "
                f"{[(self.sup_flags == f).sum() for f in (1, 0)]}, unsup "
                f"{[(self.unsup_flags == f).sum() for f in (1, 0)]}); "
                "SSOD batches mix both datasets under ONE bucket "
                "orientation, so at least one common group is required")
        weights = np.asarray(
            [sum(n_flagged[f]) for f in usable], np.float64)
        weights = weights / weights.sum()

        r_sup, r_unsup = self.sample_ratio
        p_sup = r_sup / (r_sup + r_unsup)
        for step in range(self.epoch_length):
            flag = int(rng.choice(usable, p=weights))
            sup_stream, unsup_stream = streams[flag]
            if self.by_prob:
                # reference multinomial split (semi_sampler.py:113-135):
                # samples_per_gpu indicators ~ WeightedRandomSampler with
                # replacement -> n_sup ~ Binomial(batch, p_sup); a zero
                # count on either side is bumped to 1 (the other side
                # decremented), keeping both loss groups populated
                n_sup = int(rng.binomial(self.samples_per_batch, p_sup))
                n_sup = min(max(n_sup, 1), self.samples_per_batch - 1)
            else:
                n_sup = r_sup
            n_unsup = self.samples_per_batch - n_sup
            # one global draw per step; hosts slice disjoint contiguous
            # chunks (reference rank sharding, semi_sampler.py:185-187)
            sup_all = [next(sup_stream)
                       for _ in range(n_sup * self.num_shards)]
            unsup_all = [next(unsup_stream)
                         for _ in range(n_unsup * self.num_shards)]
            s = self.shard_id
            yield (np.asarray(sup_all[s * n_sup:(s + 1) * n_sup]),
                   np.asarray(unsup_all[s * n_unsup:(s + 1) * n_unsup]),
                   flag)

    def _infinite(self, rng, ids):
        if np.isscalar(ids) or getattr(ids, "ndim", 1) == 0:
            ids = np.arange(int(ids))
        ids = np.asarray(ids)
        while True:
            for i in rng.permutation(len(ids)):
                yield int(ids[i])
