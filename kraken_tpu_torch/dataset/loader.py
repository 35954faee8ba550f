"""
kraken_tpu_torch.dataset.loader
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Host-side data loading, a copy of the JAX package's ``dataset/loader.py``:
a batch loader that prefetches samples on a thread pool, with
width-bucketed padding for recognition batches. Batches are numpy arrays;
the model moves them to its device. Bucketing pads every batch's width up
to the JAX package's geometric ladder, so both packages see the same
batch shapes.
"""
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from kraken_tpu_torch.dataset.utils import collate_sequences

logger = logging.getLogger(__name__)

__all__ = ['DataLoader', 'bucket_collate']


def bucket_collate(batch: list[dict], base: int = 64, growth: float = 1.25,
                   label_base: int = 16) -> dict:
    """
    Batch collation for CTC training and evaluation: images are padded to
    a geometric width bucket and label sequences to a geometric length
    bucket, targets emitted as a dense (N, L) int32 matrix.
    """
    from kraken_tpu_torch.inference.recognition import width_bucket
    sorted_batch = sorted(batch, key=lambda x: x['image'].shape[2], reverse=True)
    seqs = [x['image'] for x in sorted_batch]
    seq_lens = np.array([seq.shape[2] for seq in seqs], np.int32)
    target_w = width_bucket(int(seq_lens[0]), base=base, growth=growth)
    images = np.stack([np.pad(seq, ((0, 0), (0, 0), (0, target_w - seq.shape[2])))
                       for seq in seqs])
    targets = [x['target'] for x in sorted_batch]
    if isinstance(targets[0], str):
        return {'image': images, 'target': targets, 'seq_lens': seq_lens,
                'target_lens': np.array([len(t) for t in targets], np.int64)}
    target_lens = np.array([len(t) for t in targets], np.int32)
    max_l = max(1, int(target_lens.max()))
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
    thread-pool prefetch of individual samples.
    """

    def __init__(self,
                 dataset,
                 batch_size: int = 1,
                 shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 0,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or collate_sequences
        self.num_workers = num_workers
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.num_workers and self.num_workers > 0:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                # prefetch one batch ahead
                futures = [pool.submit(self._fetch, b) for b in batches[:2]]
                for i, batch_idx in enumerate(batches):
                    if i + 2 < len(batches):
                        futures.append(pool.submit(self._fetch, batches[i + 2]))
                    yield futures.pop(0).result()
        else:
            for batch_idx in batches:
                yield self._fetch(batch_idx)

    def _fetch(self, batch_idx):
        samples = [self.dataset[int(i)] for i in batch_idx]
        return self.collate_fn(samples)
