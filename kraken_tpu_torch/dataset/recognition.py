"""
kraken_tpu_torch.dataset.recognition
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Text recognition datasets (reference: kraken/lib/dataset/recognition.py),
the counterparts of the JAX package's ``dataset/recognition.py``, built on
the port's own line extraction, BiDi, codec and input transforms:

  * ArrowIPCRecognitionDataset — precompiled Arrow IPC binary datasets
    (memory-mapped, metadata-driven, split filters, alphabet tracking)
  * PolygonGTDataset — on-the-fly polygonal line extraction from
    baseline-annotated pages
  * GroundTruthDataset — axis-aligned bbox line crops

All datasets share the text transform stack (unicode normalization,
whitespace normalization, BiDi display reorder), codec encoding, random
replacement of failed samples, and im_mode tracking. ``pyarrow`` is
imported only when an Arrow file is added.
"""
import dataclasses
import io
import json
import logging
import traceback
import unicodedata
from collections import Counter
from functools import partial
from typing import TYPE_CHECKING, Callable, Literal, Optional, Union

import numpy as np
import regex
from PIL import Image

from kraken_tpu_torch.codec import Codec
from kraken_tpu_torch.containers import BaselineLine, BBoxLine, Segmentation
from kraken_tpu_torch.dataset.augmentation import DefaultAugmenter
from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.lib.bidi import get_display
from kraken_tpu_torch.lib.geometry import extract_polygons
from kraken_tpu_torch.lib.util import is_bitonal, open_image

if TYPE_CHECKING:
    from os import PathLike

logger = logging.getLogger(__name__)

__all__ = ['ArrowIPCRecognitionDataset', 'PolygonGTDataset', 'GroundTruthDataset']


def text_normalize(text: str, normalization: str) -> str:
    return unicodedata.normalize(normalization, text)


def text_whitespace_normalize(text: str) -> str:
    return regex.sub(r'\s', ' ', text).strip()


def text_reorder(text: str, base_dir=None) -> str:
    return get_display(text, base_dir=base_dir)


class _RecognitionDatasetBase:
    """Shared text-transform / im_mode / failure machinery."""

    def _init_common(self, normalization, whitespace_normalization, reorder,
                     skip_empty_lines, im_transforms, augmentation):
        self.alphabet: Counter = Counter()
        self.text_transforms: list[Callable[[str], str]] = []
        self.transforms = im_transforms
        self.aug = DefaultAugmenter() if augmentation else None
        self.skip_empty_lines = skip_empty_lines
        self.failed_samples = set()
        self.codec: Optional[Codec] = None
        self._im_mode_val = b'1'
        if normalization:
            self.text_transforms.append(partial(text_normalize, normalization=normalization))
        if whitespace_normalization:
            self.text_transforms.append(text_whitespace_normalize)
        if reorder:
            if reorder in ('L', 'R'):
                self.text_transforms.append(partial(text_reorder, base_dir=reorder))
            else:
                self.text_transforms.append(text_reorder)

    def _transform_text(self, text: str) -> str:
        for fn in self.text_transforms:
            text = fn(text)
        return text

    def _track_im_mode(self, im: np.ndarray) -> None:
        mode = b'R' if im.shape[0] == 3 else (b'L' if im.shape[0] == 1 else b'R')
        if is_bitonal(im):
            mode = b'1'
        if mode > self._im_mode_val:
            logger.info(f'Promoting dataset im_mode from {self._im_mode_val} to {mode}')
            self._im_mode_val = mode

    @property
    def im_mode(self) -> str:
        return {b'1': '1', b'L': 'L', b'R': 'RGB'}[self._im_mode_val]

    def _replace_failed(self, index):
        self.failed_samples.add(index)
        idx = np.random.randint(0, len(self))
        logger.debug(traceback.format_exc())
        logger.info(f'Sample load failed; substituting random sample {idx}')
        return self[idx]


class ArrowIPCRecognitionDataset(_RecognitionDatasetBase):
    """
    Recognition dataset over precompiled Arrow IPC files with per-line PNG
    images and split masks.
    """

    def __init__(self,
                 normalization: Optional[str] = None,
                 whitespace_normalization: bool = True,
                 skip_empty_lines: bool = True,
                 reorder: Union[bool, Literal['L', 'R']] = True,
                 im_transforms: Callable = lambda x: x,
                 augmentation: bool = False,
                 split_filter: Optional[str] = None) -> None:
        self._init_common(normalization, whitespace_normalization, reorder,
                          skip_empty_lines, im_transforms, augmentation)
        self._split_filter = split_filter
        self._num_lines = 0
        self.arrow_table = None
        self.seg_type = None
        self.legacy_polygons_status = None

    def add(self, file: Union[str, 'PathLike']) -> None:
        """Adds an Arrow IPC file, validating and merging its metadata."""
        import pyarrow as pa
        with pa.memory_map(str(file), 'rb') as source:
            ds_table = pa.ipc.open_file(source).read_all()
            raw_metadata = ds_table.schema.metadata
            if not raw_metadata or b'lines' not in raw_metadata:
                raise ValueError(f'{file} lacks a readable arrow metadata record.')
            metadata = json.loads(raw_metadata[b'lines'])
        if metadata['type'] == 'kraken_recognition_baseline':
            expected = 'baselines'
        elif metadata['type'] == 'kraken_recognition_bbox':
            expected = 'bbox'
        else:
            raise ValueError(f'Unknown type {metadata["type"]} of dataset.')
        if self.seg_type is None:
            self.seg_type = expected
        elif self.seg_type != expected:
            raise ValueError(f'File {file} has incompatible type {metadata["type"]} for '
                             f'dataset with type {self.seg_type}.')
        if self._split_filter and metadata['counts'][self._split_filter] == 0:
            logger.warning(f'No explicit split for "{self._split_filter}" in dataset {file}.')
            return
        if self.seg_type == 'bbox' and metadata.get('image_type') == 'raw' and self.transforms is not None:
            if hasattr(self.transforms, 'valid_norm'):
                self.transforms.valid_norm = True

        legacy = metadata.get('legacy_polygons', True)
        if self.legacy_polygons_status is None:
            self.legacy_polygons_status = legacy
        elif self.legacy_polygons_status != legacy:
            self.legacy_polygons_status = 'mixed'

        self.alphabet.update(metadata['alphabet'])
        num_lines = metadata['counts'][self._split_filter] if self._split_filter else metadata['counts']['all']
        if self._split_filter:
            ds_table = ds_table.filter(ds_table.column(self._split_filter))
        if self.skip_empty_lines:
            mask = np.ones(len(ds_table), dtype=bool)
            for index in range(len(ds_table)):
                text = self._transform_text(ds_table.column('lines')[index].as_py()['text'])
                if not text:
                    mask[index] = False
            num_lines = int(np.count_nonzero(mask))
            if (~mask).any():
                logger.debug(f'Filtering out {int((~mask).sum())} empty lines')
                ds_table = ds_table.filter(pa.array(mask))
        if self.arrow_table is None:
            self.arrow_table = ds_table
        else:
            self.arrow_table = pa.concat_tables([self.arrow_table, ds_table])
        self._num_lines += num_lines

    def rebuild_alphabet(self) -> None:
        """Recomputes the alphabet after text transform changes."""
        self.alphabet = Counter()
        for index in range(len(self)):
            text = self._transform_text(self.arrow_table.column('lines')[index].as_py()['text'])
            if text:
                self.alphabet.update(text)

    def encode(self, codec: Optional[Codec] = None) -> None:
        """Attaches a codec (building one from the alphabet when omitted) and
        validates encodability."""
        if codec:
            self.codec = codec
            for index in range(self._num_lines):
                text = self._transform_text(self.arrow_table.column('lines')[index].as_py()['text'])
                if text:
                    self.codec.encode(text)
        else:
            self.codec = Codec(''.join(self.alphabet.keys()))

    def no_encode(self) -> None:
        pass

    def __getitem__(self, index: int) -> dict:
        if len(self.failed_samples) == len(self):
            raise ValueError(f'All {len(self)} dataset samples failed to load.')
        try:
            sample = self.arrow_table.column('lines')[index].as_py()
            im = Image.open(io.BytesIO(sample['im']))
            im = self.transforms(im)
            if self.aug is not None:
                im = self.aug(im, index)
            self._track_im_mode(im)
            text = self._transform_text(sample['text'])
            if not text and self.skip_empty_lines:
                raise KrakenInputException('empty text line')
        except Exception:
            return self._replace_failed(index)
        return {'image': im,
                'target': self.codec.encode(text) if self.codec is not None else text}

    def __len__(self) -> int:
        return self._num_lines


class PolygonGTDataset(_RecognitionDatasetBase):
    """
    Recognition dataset extracting dewarped polygonal line images on the fly
    from baseline-annotated pages.
    """

    def __init__(self,
                 normalization: Optional[str] = None,
                 whitespace_normalization: bool = True,
                 skip_empty_lines: bool = True,
                 reorder: Union[bool, Literal['L', 'R']] = True,
                 im_transforms: Callable = lambda x: x,
                 augmentation: bool = False,
                 legacy_polygons: bool = False) -> None:
        self._init_common(normalization, whitespace_normalization, reorder,
                          skip_empty_lines, im_transforms, augmentation)
        self._images: list = []
        self._gt: list[str] = []
        self.legacy_polygons = legacy_polygons
        self.seg_type = 'baselines'

    def add(self, line: Optional[BaselineLine] = None,
            page: Optional[Segmentation] = None) -> None:
        if line:
            self.add_line(line)
        if page:
            self.add_page(page)
        if not (line or page):
            raise ValueError('The dataset needs either line or page data')

    def add_page(self, page: Segmentation) -> None:
        if page.type != 'baselines':
            raise ValueError(f'Unsupported segmentation type {page.type} (expected "baselines")')
        for line in page.lines:
            try:
                self.add_line(dataclasses.replace(line, imagename=page.imagename))
            except ValueError as e:
                logger.warning(e)

    def add_line(self, line: BaselineLine) -> None:
        if line.type != 'baselines':
            raise ValueError(f'Invalid line of type {line.type} (expected "baselines")')
        text = self._transform_text(line.text or '')
        if not text and self.skip_empty_lines:
            raise ValueError(f'Text line "{line.text}" produced an empty tensor after the transform stack')
        if not line.baseline:
            raise ValueError('Line record lacks a baseline')
        if not line.boundary:
            raise ValueError('Line record lacks a boundary polygon')
        self._images.append((line.imagename, line.baseline, line.boundary))
        self._gt.append(text)
        self.alphabet.update(text)

    def encode(self, codec: Optional[Codec] = None) -> None:
        self.codec = codec if codec else Codec(''.join(self.alphabet.keys()))
        self.training_set = [(im, self.codec.encode(gt))
                             for im, gt in zip(self._images, self._gt)]

    def no_encode(self) -> None:
        self.training_set = list(zip(self._images, self._gt))

    def __getitem__(self, index: int) -> dict:
        if len(self.failed_samples) == len(self):
            raise ValueError(f'All {len(self)} dataset samples failed to load.')
        item = self.training_set[index]
        try:
            imagename, baseline, boundary = item[0]
            im = imagename if isinstance(imagename, Image.Image) else open_image(imagename)
            seg = Segmentation(type='baselines', imagename=imagename,
                               text_direction='horizontal-lr',
                               lines=[BaselineLine('id_0', baseline=baseline, boundary=boundary)],
                               script_detection=True, regions={}, line_orders=[])
            line_im, _ = next(extract_polygons(im, seg, legacy=self.legacy_polygons))
            arr = self.transforms(line_im)
            self._track_im_mode(arr)
            if self.aug is not None:
                arr = self.aug(arr, index)
        except Exception:
            return self._replace_failed(index)
        return {'image': arr, 'target': item[1]}

    def __len__(self) -> int:
        return len(self._images)


class GroundTruthDataset(_RecognitionDatasetBase):
    """Recognition dataset over axis-aligned bbox line crops."""

    def __init__(self,
                 normalization: Optional[str] = None,
                 whitespace_normalization: bool = True,
                 skip_empty_lines: bool = True,
                 reorder: Union[bool, str] = True,
                 im_transforms: Callable = lambda x: x,
                 augmentation: bool = False) -> None:
        self._init_common(normalization, whitespace_normalization, reorder,
                          skip_empty_lines, im_transforms, augmentation)
        self._images: list = []
        self._gt: list[str] = []
        self.seg_type = 'bbox'

    def add(self, line: Optional[BBoxLine] = None,
            page: Optional[Segmentation] = None) -> None:
        if line:
            self.add_line(line)
        if page:
            self.add_page(page)
        if not (line or page):
            raise ValueError('The dataset needs either line or page data')

    def add_page(self, page: Segmentation) -> None:
        if page.type != 'bbox':
            raise ValueError(f'Unsupported segmentation type {page.type} (expected "bbox")')
        for line in page.lines:
            try:
                self.add_line(dataclasses.replace(line, imagename=page.imagename))
            except ValueError as e:
                logger.warning(e)

    def add_line(self, line: BBoxLine) -> None:
        if line.type != 'bbox':
            raise ValueError(f'Invalid line of type {line.type} (expected "bbox")')
        text = self._transform_text(line.text or '')
        if not text and self.skip_empty_lines:
            raise ValueError(f'Text line "{line.text}" produced an empty tensor after the transform stack')
        if not line.bbox:
            raise ValueError('Line record lacks a bounding box')
        self._images.append((line.imagename, line.bbox))
        self._gt.append(text)
        self.alphabet.update(text)

    def encode(self, codec: Optional[Codec] = None) -> None:
        self.codec = codec if codec else Codec(''.join(self.alphabet.keys()))
        self.training_set = [(im, self.codec.encode(gt))
                             for im, gt in zip(self._images, self._gt)]

    def no_encode(self) -> None:
        self.training_set = list(zip(self._images, self._gt))

    def __getitem__(self, index: int) -> dict:
        if len(self.failed_samples) == len(self):
            raise ValueError(f'All {len(self)} dataset samples failed to load.')
        item = self.training_set[index]
        try:
            imagename, bbox = item[0]
            im = imagename if isinstance(imagename, Image.Image) else open_image(imagename)
            im = im.crop(bbox)
            arr = self.transforms(im)
            self._track_im_mode(arr)
            if self.aug is not None:
                arr = self.aug(arr, index)
        except Exception:
            return self._replace_failed(index)
        return {'image': arr, 'target': item[1]}

    def __len__(self) -> int:
        return len(self._images)
