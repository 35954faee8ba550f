"""
kraken_tpu_torch.rpred
~~~~~~~~~~~~~~~~~~~~~~

Legacy functional recognition API (reference: kraken/rpred.py), a copy of
the JAX package's ``rpred.py``: `rpred` recognizes all lines of a
segmentation with one model, `mm_rpred` dynamically selects models by line
type tag. The networks run where their SeqRecognizers were placed (the card
unless the caller asked for the CPU). Deprecated in favour of
kraken_tpu_torch.tasks.RecognitionTaskModel, kept for API parity.
"""
import dataclasses
import logging
import warnings
from collections import defaultdict
from typing import TYPE_CHECKING, Optional, Union

import numpy as np

from kraken_tpu_torch.containers import BaselineOCRRecord, BBoxOCRRecord
from kraken_tpu_torch.dataset import ImageInputTransforms
from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.lib.geometry import extract_polygons
from kraken_tpu_torch.lib.util import get_im_str, is_bitonal

if TYPE_CHECKING:
    from PIL import Image
    from kraken_tpu_torch.containers import Segmentation
    from kraken_tpu_torch.lib.models import SeqRecognizer

__all__ = ['mm_rpred', 'rpred']

logger = logging.getLogger(__name__)


def _get_type(tags: Optional[dict], default: str = 'default') -> str:
    if tags is None:
        return default
    ot = tags.get('type', [{'type': default}])[0]
    tt = ot.get('type')
    return tt if tt is not None else default


def _resolve_type_to_model(tags: Optional[dict], model_map: dict,
                           default=None):
    tag = None
    if tags is not None:
        try:
            tag = _get_type(tags)
        except Exception:
            pass
    if not tag and default:
        return 'default', default
    if tag in model_map:
        return tag, model_map[tag]
    if tag and default:
        return tag, default
    raise KrakenInputException(f'No model for type {tag}')


class mm_rpred:
    """
    Multi-model recognition: maps line type tags to recognizers and yields
    one OCR record per line in order.
    """

    def __init__(self,
                 nets: dict[str, 'SeqRecognizer'],
                 im: 'Image.Image',
                 bounds: 'Segmentation',
                 pad: int = 16,
                 bidi_reordering: Union[bool, str] = True,
                 tags_ignore: Optional[list[str]] = None,
                 no_legacy_polygons: bool = False):
        warnings.warn('`rpred.mm_rpred` is deprecated; use `RecognitionTaskModel` instead.',
                      DeprecationWarning)
        seg_types = set(rec.seg_type for rec in nets.values())
        if isinstance(nets, defaultdict) and nets.default_factory:
            seg_types.add(nets.default_factory().seg_type)
            self._resolve = lambda tags, m: _resolve_type_to_model(tags, m, nets.default_factory())
        else:
            self._resolve = _resolve_type_to_model
        tags_ignore = tags_ignore or []
        self.have_tags = bounds.script_detection
        if bounds.type not in seg_types or len(seg_types) > 1:
            logger.warning(f'Models expecting segmentation types {seg_types} are being run on '
                           f'a segmentation of type {bounds.type}; recognition quality '
                           'will likely suffer badly')
        one_channel_modes = set(rec.nn.one_channel_mode for rec in nets.values())
        if '1' in one_channel_modes and len(one_channel_modes) > 1:
            raise ValueError('Cannot mix binary-input and grayscale-input recognition models.')
        if '1' in one_channel_modes and not is_bitonal(im):
            logger.warning('Binary-input models applied to a non-bitonal image '
                           f'(mode {im.mode}); expect severely degraded recognition quality')

        self.len = len(bounds.lines)
        self.line_iter = iter(bounds.lines)
        if bounds.type == 'baselines':
            valid_norm = False
            self.next_iter = self._recognize_baseline_line
            self._empty_cls = BaselineOCRRecord
        else:
            valid_norm = True
            self.next_iter = self._recognize_box_line
            self._empty_cls = BBoxOCRRecord

        if isinstance(nets, defaultdict) and nets.default_factory:
            network = nets.default_factory()
            batch, channels, height, width = network.nn.input
            self.ts = defaultdict(lambda: ImageInputTransforms(batch, height, width, channels,
                                                               (pad, 0), valid_norm))
        else:
            self.ts = {}

        if self.have_tags:
            tags = set(_get_type(x.tags) for x in bounds.lines)
            logger.info(f'Running {len(nets)} script-specific recognizers over {get_im_str(im)} '
                        f'with {self.len} lines')
            missing = []
            filtered = []
            for tag in tags:
                if not isinstance(nets, defaultdict) and (not nets.get(tag) and tag not in tags_ignore):
                    missing.append(tag)
                elif tag not in tags_ignore:
                    filtered.append(tag)
            if missing:
                raise KrakenInputException(f'Missing models for tags {set(missing)}')
            self.ts = {}
            for tag in filtered:
                network = nets[tag]
                batch, channels, height, width = network.nn.input
                self.ts[tag] = ImageInputTransforms(batch, height, width, channels,
                                                    (pad, 0), valid_norm)
        if not isinstance(self.ts, defaultdict) and not self.ts:
            raise ValueError('Input lines carry no tags and the model mapping has no default.')

        self.im = im
        # the straight-line extractor's page array, read once for this run
        self._page_array = np.asarray(im) if im.mode == 'L' else None
        self.nets = nets
        self.bidi_reordering = bidi_reordering
        self.pad = pad
        self.bounds = bounds
        self.tags_ignore = tags_ignore
        self.no_legacy_polygons = no_legacy_polygons

    # ------------------------------------------------------------ plumbing
    def _choose_legacy(self, net) -> bool:
        if net.nn.use_legacy_polygons:
            if self.no_legacy_polygons:
                warnings.warn('Forcing the new polygon extractor on a legacy-trained model; '
                              'accuracy may drop.')
                return False
            warnings.warn('Falling back to the slow legacy polygon extractor (model predates '
                          'the new method); retraining enables the fast path.')
            return True
        return False

    def _scale_val(self, val, min_val, max_val):
        return int(round(min(max(((val * self.net_scale) - self.pad) * self.in_scale, min_val),
                             max_val - 1)))

    def _finalize(self, rec):
        if self.bidi_reordering:
            return rec.logical_order(base_dir=self.bidi_reordering
                                     if self.bidi_reordering in ('L', 'R') else None)
        return rec.display_order(None)

    def _prepare_line(self, line, empty):
        """Common extraction + transform for one line; returns (box, ts_box)
        or an empty record."""
        if self.have_tags and self.tags_ignore:
            if (ltype := _get_type(line.tags)) in self.tags_ignore:
                logger.info(f'Skipping line of unsupported type {ltype}.')
                return empty('', (), (), line), None, None, None
        tag, net = self._resolve(line.tags, self.nets)
        legacy = self._choose_legacy(net)
        seg = dataclasses.replace(self.bounds, lines=[line])
        try:
            box, _ = next(extract_polygons(self.im, seg, legacy=legacy,
                                           page_array=self._page_array))
        except ValueError as e:
            logger.warning(f'Extracting line failed: {e}')
            return empty('', [], [], line), None, None, None
        self.box = box
        if 0 in box.size:
            logger.warning(f'{line} has a zero-sized extent; yielding an empty record.')
            return empty('', [], [], line), None, None, None
        try:
            ts_box = self.ts[tag](box)
        except Exception as e:
            logger.warning(f'Line tensor conversion raised {e}. Emitting empty record.')
            return empty('', [], [], line), None, None, None
        if ts_box.max() == ts_box.min():
            logger.warning('Line image came out empty after transforms; yielding an empty record.')
            return empty('', [], [], line), None, None, None
        return None, box, ts_box, net

    # ---------------------------------------------------------- recognizers
    def _recognize_baseline_line(self, line):
        rec, box, ts_box, net = self._prepare_line(line, BaselineOCRRecord)
        if rec is not None:
            return rec
        preds = net.predict(ts_box[None])[0]
        self.net_scale = ts_box.shape[2] / net.outputs.shape[2]
        self.in_scale = box.size[0] / (ts_box.shape[2] - 2 * self.pad)
        pred = ''.join(x[0] for x in preds)
        pos = []
        conf = []
        for _, start, end, c in preds:
            pos.append([self._scale_val(start, 0, box.size[0]),
                        self._scale_val(end, 0, box.size[0])])
            conf.append(c)
        return self._finalize(BaselineOCRRecord(pred, pos, conf, line))

    def _recognize_box_line(self, line):
        line.text_direction = self.bounds.text_direction
        rec, box, ts_box, net = self._prepare_line(line, BBoxOCRRecord)
        if rec is not None:
            return rec
        preds = net.predict(ts_box[None])[0]
        self.net_scale = ts_box.shape[2] / net.outputs.shape[2]
        self.in_scale = box.size[0] / (ts_box.shape[2] - 2 * self.pad)
        pred = ''.join(x[0] for x in preds)
        pos = []
        conf = []
        for _, start, end, c in preds:
            if self.bounds.text_direction.startswith('horizontal'):
                x, ymin, _, ymax = line.bbox
                xmin = x + self._scale_val(start, 0, box.size[0])
                xmax = x + self._scale_val(end, 0, box.size[0])
                pos.append([[xmin, ymin], [xmin, ymax], [xmax, ymax], [xmax, ymin]])
            else:
                xmin, y, xmax, _ = line.bbox
                ymin = y + self._scale_val(start, 0, box.size[1])
                ymax = y + self._scale_val(end, 0, box.size[1])
                pos.append([[xmin, ymin], [xmax, ymin], [xmax, ymax], [xmin, ymax]])
            conf.append(c)
        return self._finalize(BBoxOCRRecord(pred, pos, conf, line))

    def __next__(self):
        return self.next_iter(next(self.line_iter))

    def __iter__(self):
        return self

    def __len__(self):
        return self.len


def rpred(network: 'SeqRecognizer',
          im: 'Image.Image',
          bounds: 'Segmentation',
          pad: int = 16,
          bidi_reordering: Union[bool, str] = True,
          no_legacy_polygons: bool = False):
    """
    Recognizes all lines of a segmentation with one model.

    Yields:
        ocr_record instances with text, positions, and confidences.
    """
    return mm_rpred(defaultdict(lambda: network), im, bounds, pad,
                    bidi_reordering, no_legacy_polygons=no_legacy_polygons)
