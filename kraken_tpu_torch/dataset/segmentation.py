"""
kraken_tpu_torch.dataset.segmentation
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Baseline/region segmentation dataset (reference:
kraken/lib/dataset/segmentation.py BaselineSet), a copy of the JAX
package's ``dataset/segmentation.py``: pages are rasterized into
per-class target heatmaps — buffered baseline strips, start/end separator
patches at the line ends, and filled region polygons. Rasterization uses
OpenCV polygon drawing instead of shapely buffering + skimage.draw.
"""
import logging
import traceback
from collections import defaultdict
from itertools import groupby
from typing import TYPE_CHECKING, Any, Callable

import cv2
import numpy as np
from PIL import Image

from kraken_tpu_torch.dataset.augmentation import SegmentationAugmenter
from kraken_tpu_torch.dataset.utils import _get_type
from kraken_tpu_torch.lib.geometry import polyline_dists, scale_regions
from kraken_tpu_torch.lib.util import is_bitonal, open_image

if TYPE_CHECKING:
    from kraken_tpu_torch.containers import Segmentation

logger = logging.getLogger(__name__)

__all__ = ['BaselineSet']


class BaselineSet:
    """
    Dataset for training a baseline/region segmentation model.

    The class mapping must contain 'aux' (with reserved indices 0/1 for
    `_start_separator`/`_end_separator`), 'baselines', and 'regions'
    sections with disjoint indices ≥ 2.
    """

    def __init__(self,
                 class_mapping: dict[str, dict[str, int]],
                 line_width: int = 4,
                 padding: tuple[int, int] = (0, 0),
                 im_transforms: Callable[[Any], np.ndarray] = lambda x: x,
                 augmentation: bool = False) -> None:
        required = {'aux', 'baselines', 'regions'}
        if set(class_mapping.keys()) != required:
            raise ValueError(f'class_mapping requires exactly the keys {required}, '
                             f'got {set(class_mapping.keys())}')
        for req in ('_start_separator', '_end_separator'):
            if req not in class_mapping['aux']:
                raise ValueError(f"aux class mapping is missing required key '{req}'")
        for section, sub in class_mapping.items():
            for key, val in sub.items():
                if not isinstance(val, int) or isinstance(val, bool) or val < 0:
                    raise ValueError(f'class_mapping[{section!r}][{key!r}] needs a '
                                     f'non-negative integer index, got {val!r}')
        for section in ('baselines', 'regions'):
            for key, val in class_mapping[section].items():
                if val < 2:
                    raise ValueError(f'class_mapping[{section!r}][{key!r}] has index {val}, '
                                     'but indices 0 and 1 are reserved for aux classes.')
        overlap = set(class_mapping['baselines'].values()) & set(class_mapping['regions'].values())
        if overlap:
            raise ValueError('Baseline and region classes must use disjoint indices; '
                             f'shared: {overlap}')
        self.class_mapping = class_mapping
        self.line_width = line_width
        self.pad = padding
        self.transforms = im_transforms
        self.aug = SegmentationAugmenter() if augmentation else None
        self.imgs: list = []
        self.targets: list = []
        self.failed_samples = set()
        self.class_stats = {'baselines': defaultdict(int), 'regions': defaultdict(int)}
        self.seg_type = None
        self._im_mode_val = b'1'

    @property
    def num_classes(self) -> int:
        return max(v for d in self.class_mapping.values() for v in d.values()) + 1

    @property
    def canonical_class_mapping(self) -> dict[str, dict[str, int]]:
        """One name per label index (first by insertion order wins)."""
        result = {}
        for section, sub in self.class_mapping.items():
            seen = set()
            canonical = {}
            for key, idx in sub.items():
                if idx not in seen:
                    seen.add(idx)
                    canonical[key] = idx
            result[section] = canonical
        return result

    @property
    def merged_classes(self) -> dict[str, dict[str, list[str]]]:
        """Aliases of merged classes: {section: {canonical: [aliases]}}."""
        result = {}
        for section, sub in self.class_mapping.items():
            by_idx = defaultdict(list)
            for key, idx in sub.items():
                by_idx[idx].append(key)
            result[section] = {names[0]: names[1:] for names in by_idx.values()
                               if len(names) > 1}
        return result

    def add(self, doc: 'Segmentation') -> None:
        """Adds a page-level Segmentation to the dataset."""
        if doc.type != 'baselines':
            raise ValueError(f'{doc} is of type {doc.type}. Expected "baselines".')
        baselines_ = defaultdict(list)
        for line in doc.lines:
            tag = _get_type(line.tags)
            # index rather than test membership: auto-assigning mappings
            # (defaultdict / ketos' filtered maps) allocate classes in
            # __missing__, which `in` would never trigger
            try:
                cls_idx = self.class_mapping['baselines'][tag]
            except KeyError:
                continue
            baselines_[cls_idx].append(line.baseline)
            self.class_stats['baselines'][tag] += 1
        regions_ = defaultdict(list)
        for k, v in doc.regions.items():
            try:
                cls_idx = self.class_mapping['regions'][k]
            except KeyError:
                continue
            valid = [x for x in v if x.boundary]
            regions_[cls_idx].extend(valid)
            self.class_stats['regions'][k] += len(valid)
        self.targets.append({'baselines': baselines_, 'regions': regions_})
        self.imgs.append(doc.imagename)

    def transform(self, image: Image.Image, target: dict):
        """Rasterizes baselines/separators/regions into the target stack."""
        orig_size = image.size
        arr = self.transforms(image)
        scale = (arr.shape[2] - 2 * self.pad[1]) / orig_size[0]
        h = arr.shape[1] - 2 * self.pad[0]
        w = arr.shape[2] - 2 * self.pad[1]
        t = np.zeros((self.num_classes, h, w), np.float32)
        start_cls = self.class_mapping['aux']['_start_separator']
        end_cls = self.class_mapping['aux']['_end_separator']

        scaled_baselines = defaultdict(list)
        for cls_idx, lines in target['baselines'].items():
            for line in lines:
                line = [k for k, _ in groupby(map(tuple, line))]
                pts = np.array(line, float) * scale
                scaled_baselines[cls_idx].append(pts.tolist())
                ipts = np.round(pts).astype(np.int32)
                # baseline strip: polyline drawn at the requested width
                cv2.polylines(t[cls_idx], [ipts.reshape(-1, 1, 2)], False, 1.0,
                              max(1, self.line_width))
                # start/end separators: thick patches over the first/last
                # ~5px of the line, minus the baseline strip itself
                dists = polyline_dists(pts)
                offset = min(5, dists[-1] / 2)
                for sep_cls, seg_pts in ((start_cls, self._clip_polyline(pts, dists, 0, offset)),
                                         (end_cls, self._clip_polyline(pts, dists, dists[-1] - offset, dists[-1]))):
                    sep = np.zeros((h, w), np.float32)
                    cv2.polylines(sep, [np.round(seg_pts).astype(np.int32).reshape(-1, 1, 2)],
                                  False, 1.0, max(1, 2 * self.line_width))
                    t[sep_cls] = np.maximum(t[sep_cls], sep)
                # separators exclude the baseline strip
                baseline_mask = t[cls_idx] > 0
                t[start_cls][baseline_mask] = 0
                t[end_cls][baseline_mask] = 0
        for cls_idx, regions in target['regions'].items():
            for region in regions:
                poly = np.array(scale_regions([region.boundary], float(scale))[0], np.int32)
                cv2.fillPoly(t[cls_idx], [poly.reshape(-1, 1, 2)], 1.0)
        if any(self.pad):
            t = np.pad(t, ((0, 0), (self.pad[0], self.pad[0]), (self.pad[1], self.pad[1])))
        if self.aug:
            arr, t = self.aug(arr, t)
        return arr, t, dict(scaled_baselines)

    @staticmethod
    def _clip_polyline(pts: np.ndarray, dists: np.ndarray, d0: float, d1: float) -> np.ndarray:
        """Sub-polyline between arc lengths d0 and d1."""
        def _point_at(d):
            seg = int(np.clip(np.searchsorted(dists, d), 1, len(pts) - 1))
            denom = dists[seg] - dists[seg - 1]
            frac = (d - dists[seg - 1]) / denom if denom > 0 else 0
            return pts[seg - 1] + frac * (pts[seg] - pts[seg - 1])
        inner = pts[(dists > d0) & (dists < d1)]
        return np.vstack([[_point_at(d0)], inner, [_point_at(d1)]])

    def _track_im_mode(self, im: np.ndarray) -> None:
        mode = b'R' if im.shape[0] == 3 else (b'L' if im.shape[0] == 1 else b'R')
        if is_bitonal(im):
            mode = b'1'
        if mode > self._im_mode_val:
            self._im_mode_val = mode

    def __getitem__(self, idx: int) -> dict:
        if len(self.failed_samples) == len(self):
            raise ValueError(f'All {len(self)} dataset samples failed to load.')
        im = self.imgs[idx]
        target = self.targets[idx]
        try:
            if not isinstance(im, Image.Image):
                im = open_image(im)
            arr, t, baselines = self.transform(im, target)
            self._track_im_mode(arr)
            return {'image': arr, 'target': t, 'baselines': baselines}
        except Exception:
            self.failed_samples.add(idx)
            new_idx = np.random.randint(0, len(self.imgs))
            logger.debug(traceback.format_exc())
            logger.info(f'Sample load failed; substituting random sample {new_idx}')
            return self[new_idx]

    def __len__(self) -> int:
        return len(self.imgs)

    @property
    def im_mode(self) -> str:
        return {b'1': '1', b'L': 'L', b'R': 'RGB'}[self._im_mode_val]
