"""
kraken_tpu_torch.dataset.loader
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Host-side data loading, a copy of the JAX package's ``dataset/loader.py``:
a batch loader that prefetches samples on a thread pool, with
width-bucketed padding for recognition batches. Batches are numpy arrays;
the model moves them to its device. Bucketing pads every batch's width up
to the JAX package's geometric ladder, so both packages see the same
batch shapes.

Sharded over the ranks of a data-parallel run (:meth:`DataLoader.shard`),
every rank walks rank 0's shuffle order, pads each global batch of indices
to a multiple of the world size by repeating its first indices (as
``parallel.pad_batch_to_multiple`` pads a batch) and loads only its own
contiguous rows; before the collate pads them, the ranks agree on the
shape of the global batch (the widest line's width and the longest label),
so that each shard has the shape its rows have in the global batch.
"""
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from kraken_tpu_torch.dataset.utils import collate_sequences

logger = logging.getLogger(__name__)

__all__ = ['DataLoader', 'bucket_collate', 'bucket_dims']


def bucket_dims(sample: dict) -> tuple[int, int]:
    """What :func:`bucket_collate` pads a sample to the batch's largest of:
    its width and its label length (0 for a text target)."""
    target = sample['target']
    return sample['image'].shape[2], 0 if isinstance(target, str) else len(target)


def bucket_collate(batch: list[dict], base: int = 64, growth: float = 1.25,
                   label_base: int = 16, dims=None) -> dict:
    """
    Batch collation for CTC training and evaluation: images are padded to
    a geometric width bucket and label sequences to a geometric length
    bucket, targets emitted as a dense (N, L) int32 matrix. `dims`, the
    (largest, smallest) :func:`bucket_dims` over a sharded global batch,
    sets the buckets in place of this batch's own widest line and longest
    label.
    """
    from kraken_tpu_torch.inference.recognition import width_bucket
    sorted_batch = sorted(batch, key=lambda x: x['image'].shape[2], reverse=True)
    seqs = [x['image'] for x in sorted_batch]
    seq_lens = np.array([seq.shape[2] for seq in seqs], np.int32)
    widest = int(seq_lens[0]) if dims is None else int(dims[0][0])
    target_w = width_bucket(widest, base=base, growth=growth)
    images = np.stack([np.pad(seq, ((0, 0), (0, 0), (0, target_w - seq.shape[2])))
                       for seq in seqs])
    targets = [x['target'] for x in sorted_batch]
    if isinstance(targets[0], str):
        return {'image': images, 'target': targets, 'seq_lens': seq_lens,
                'target_lens': np.array([len(t) for t in targets], np.int64)}
    target_lens = np.array([len(t) for t in targets], np.int32)
    max_l = max(1, int(target_lens.max()) if dims is None else int(dims[0][1]))
    bucket_l = label_base
    while bucket_l < max_l:
        bucket_l = int(np.ceil(bucket_l * growth))
    label_mat = np.zeros((len(targets), bucket_l), np.int32)
    for i, t in enumerate(targets):
        label_mat[i, :len(t)] = np.asarray(t)
    return {'image': images, 'target': label_mat, 'seq_lens': seq_lens,
            'target_lens': target_lens}


class DataLoader:
    """
    Iterates a map-style dataset in (optionally shuffled) batches with
    thread-pool prefetch of individual samples. `dims_fn` gives the sizes
    `collate_fn` pads a sample to the batch's largest of, which the ranks of
    a sharded loader agree on (``collate_fn(samples, dims=(largest,
    smallest))``); without it a shard collates alone.
    """

    def __init__(self,
                 dataset,
                 batch_size: int = 1,
                 shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 0,
                 seed: Optional[int] = None,
                 dims_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or collate_sequences
        self.num_workers = num_workers
        self.dims_fn = dims_fn
        self.world = None
        self._rng = np.random.RandomState(seed)

    def shard(self, world) -> 'DataLoader':
        """Shards the batches over the ranks of `world`
        (``parallel.World``): every rank takes rank 0's shuffle state and
        from then on loads only its rows of each global batch."""
        self._rng.set_state(world.broadcast_object(self._rng.get_state()))
        self.world = world
        return self

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batches(self) -> list[np.ndarray]:
        """The next epoch's batches of dataset indices (this rank's rows of
        each global batch, when sharded); draws the shuffle."""
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.world is not None:
            from kraken_tpu_torch.parallel import pad_batch_to_multiple
            padded = (pad_batch_to_multiple({'i': idx}, self.world.size)['i'] for idx in batches)
            batches = [idx[self.world.rows(len(idx))] for idx in padded]
        return batches

    def __iter__(self):
        batches = self.batches()
        # a shard's samples load on the pool and collate here, in order,
        # after the ranks agree on the global batch's shape
        fetch = self._fetch if self.world is None else self._load
        finish = (lambda b: b) if self.world is None else self._collate_shard
        if self.num_workers and self.num_workers > 0:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                # prefetch one batch ahead
                futures = [pool.submit(fetch, b) for b in batches[:2]]
                for i, batch_idx in enumerate(batches):
                    if i + 2 < len(batches):
                        futures.append(pool.submit(fetch, batches[i + 2]))
                    yield finish(futures.pop(0).result())
        else:
            for batch_idx in batches:
                yield finish(fetch(batch_idx))

    def _load(self, batch_idx) -> list:
        return [self.dataset[int(i)] for i in batch_idx]

    def _fetch(self, batch_idx):
        return self.collate_fn(self._load(batch_idx))

    def _collate_shard(self, samples: list):
        if self.dims_fn is None:
            return self.collate_fn(samples)
        dims = np.array([self.dims_fn(s) for s in samples], np.int64)
        return self.collate_fn(samples, dims=self.world.extrema(dims.max(0), dims.min(0)))
