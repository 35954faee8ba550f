"""
kraken_tpu_torch.dataset.ro
~~~~~~~~~~~~~~~~~~~~~~~~~~~

Reading-order training datasets, the counterparts of the JAX package's
``dataset/ro.py`` (reference: kraken/lib/dataset/ro.py): `PairWiseROSet`
samples random ordered pairs of lines (or regions) of a page for training,
`PageWiseROSet` gives all pairs of a page for validation. Features are the
one-hot class and the normalised center, start and end points
(``ro/features.py``).

Pages are XML files (read by :class:`kraken_tpu_torch.xml.XMLPage`, which
needs ``lxml``) or Segmentations of baseline pages: their lines in their
order (the implicit line order), their regions by type, their size read
from their image.
"""
import logging
from collections import defaultdict
from math import factorial
from typing import Literal, Optional, Sequence

import numpy as np

from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.dataset.utils import _get_type
from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.ro.features import element_features

logger = logging.getLogger(__name__)

__all__ = ['PairWiseROSet', 'PageWiseROSet']


def _num_classes_from_mapping(class_mapping: dict[str, int]) -> int:
    if not class_mapping:
        return 1
    return max(0, *class_mapping.values()) + 1


def _ordered_elements(page, mode: str, level: str, ro_id: Optional[str]):
    """(elements in reading order, image size) of an XML file or a
    Segmentation."""
    if isinstance(page, Segmentation):
        from PIL import Image
        im = page.imagename
        size = im.size if isinstance(im, Image.Image) else Image.open(im).size
        if level == 'baselines':
            return list(page.lines), size
        if level == 'regions':
            return [r for regs in (page.regions or {}).values() for r in regs], size
        raise ValueError(f'Invalid RO type {level}')
    from kraken_tpu_torch.xml import XMLPage
    doc = XMLPage(page, filetype=mode)
    if level == 'baselines':
        return doc.get_sorted_lines(ro_id or 'line_implicit'), doc.image_size
    if level == 'regions':
        return doc.get_sorted_regions(ro_id or 'region_implicit'), doc.image_size
    raise ValueError(f'Invalid RO type {level}')


class _ROSetBase:
    def __init__(self, files: Sequence, class_mapping: dict[str, int],
                 mode: Optional[Literal['alto', 'page', 'xml']] = 'xml',
                 level: Literal['regions', 'baselines'] = 'baselines',
                 ro_id: Optional[str] = None):
        if mode not in ('alto', 'page', 'xml'):
            raise Exception('invalid dataset mode')
        self.class_mapping = class_mapping
        self.class_stats = defaultdict(int)
        self.failed_samples: list = []
        self.data: list = []
        # pairs drawn from numpy's global state (`ketos --seed` seeds it)
        self._rng = np.random.RandomState(np.random.randint(0, 2**31 - 1))
        num_classes = _num_classes_from_mapping(class_mapping)
        for file in files:
            try:
                order, image_size = _ordered_elements(file, mode, level, ro_id)
            except (KrakenInputException, ValueError) as e:
                logger.warning(e)
                continue
            elements = []
            for el in order:
                tag = _get_type(el.tags)
                if tag in class_mapping:
                    _, feats = element_features(el, image_size, class_mapping, num_classes)
                    elements.append({'type': tag, 'features': feats})
                    self.class_stats[tag] += 1
            if len(elements) > 1:
                self.data.append(elements)
            else:
                logger.info(f'Page {file} has less than 2 elements. Skipping')

    @property
    def num_classes(self) -> int:
        return _num_classes_from_mapping(self.class_mapping)

    @property
    def canonical_class_mapping(self) -> dict[str, int]:
        seen = set()
        canonical = {}
        for key, idx in self.class_mapping.items():
            if idx not in seen:
                seen.add(idx)
                canonical[key] = idx
        return canonical

    @property
    def merged_classes(self) -> dict[str, list[str]]:
        by_idx = defaultdict(list)
        for key, idx in self.class_mapping.items():
            by_idx[idx].append(key)
        return {names[0]: names[1:] for names in by_idx.values() if len(names) > 1}

    def get_feature_dim(self) -> int:
        return 2 * self.num_classes + 12


class PairWiseROSet(_ROSetBase):
    """Random ordered element pairs of a page (training)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._num_pairs = sum(int(factorial(len(p)) / factorial(len(p) - 2)) for p in self.data)

    def __getitem__(self, idx: int) -> dict:
        page = self.data[self._rng.randint(len(self.data))]
        idx0 = idx1 = 0
        while idx0 == idx1:
            idx0, idx1 = self._rng.randint(len(page), size=2)
        x = np.concatenate([page[idx0]['features'], page[idx1]['features']])
        y = np.float32(0 if idx0 >= idx1 else 1)
        return {'sample': x, 'target': y}

    def __len__(self) -> int:
        return self._num_pairs


class PageWiseROSet(_ROSetBase):
    """All ordered element pairs of one page an item (validation)."""

    def __getitem__(self, idx: int) -> dict:
        page = self.data[idx]
        xs = []
        ys = []
        n = len(page)
        for i in range(n):
            for j in range(n):
                if i == j and n != 1:
                    continue
                xs.append(np.concatenate([page[i]['features'], page[j]['features']]))
                ys.append(np.float32(0 if i >= j else 1))
        return {'sample': np.stack(xs), 'target': np.stack(ys), 'num_lines': n}

    def __len__(self) -> int:
        return len(self.data)
