"""
kraken_tpu_torch.tasks.segmentation
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Layout analysis task wrapper (reference: kraken/tasks/segmentation.py), the
counterpart of the JAX package's ``tasks/segmentation.py``: runs one or
more segmentation models and merges their outputs (region re-association,
heuristic reading order). Neural reading-order models are not ported yet
(ROADMAP.md, queue 1, item 7): a collection holding one raises.
"""
import logging
from dataclasses import replace
from typing import TYPE_CHECKING, Optional, Union

from kraken_tpu_torch.containers import BaselineLine, Segmentation
from kraken_tpu_torch.lib.geometry import is_in_region
from kraken_tpu_torch.models import load_models

if TYPE_CHECKING:
    from os import PathLike
    from PIL import Image
    from kraken_tpu_torch.configs import SegmentationInferenceConfig

logger = logging.getLogger(__name__)

__all__ = ['SegmentationTaskModel']


def _line_midpoint_in_region(line, region_boundary) -> bool:
    if getattr(line, 'baseline', None):
        return is_in_region(line.baseline, region_boundary)
    if getattr(line, 'bbox', None):
        x0, y0, x1, y1 = line.bbox
        box = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        return is_in_region(box + box[:1], region_boundary)
    return False


class SegmentationTaskModel:
    """
    A collection of models performing page segmentation (region detection,
    line detection, reading order). Without a neural reading order model a
    spatial heuristic is used.

    Raises:
        ValueError: when no segmentation models are present or reading-order
                    models conflict.
    """

    def __init__(self, models: list):
        self.seg_models = [net for net in models if 'segmentation' in net.model_type]
        self.ro_models = [net for net in models if 'reading_order' in net.model_type]
        if not self.seg_models:
            raise ValueError(f'Model list contains no segmentation model: {models}.')
        seg_class_mapping = self.seg_models[0].user_metadata.get('class_mapping', {})
        levels = set()
        for m in self.ro_models:
            level = m.user_metadata.get('level', 'baselines')
            if level in levels:
                raise ValueError(f'More than one reading order model at level `{level}`.')
            levels.add(level)
            ro_cm = m.user_metadata.get('class_mapping', {}) or m.class_mapping or {}
            seg_cm = seg_class_mapping.get(level, {})
            diff = set(ro_cm.keys()).symmetric_difference(seg_cm.keys())
            diff.discard('default')
            if diff:
                raise ValueError(f'RO model class mapping at level `{level}` is '
                                 f'incompatible with the segmentation model: {diff}')

    def predict(self, im: 'Image.Image', config: 'SegmentationInferenceConfig') -> Segmentation:
        """
        Runs all segmentation models and merges their outputs into one
        Segmentation with reading orders applied.
        """
        segs = []
        for net in self.seg_models:
            logger.info(f'Applying model {net}.')
            net.prepare_for_inference(config)
            segs.append(net.predict(im))
        segmentation = self._merge_segmentations(segs, config)
        return self._compute_additional_line_orders(segmentation, config, im_size=im.size)

    @classmethod
    def load_model(cls, path: Optional[Union[str, 'PathLike']] = None) -> 'SegmentationTaskModel':
        """
        Loads segmentation models from `path` (the packaged default BLLA
        model when omitted).
        """
        if not path:
            from kraken_tpu_torch.lib.util import default_segmentation_model
            path = default_segmentation_model()
            logger.info(f'Segmentation model not specified; using the default from {path}.')
        return cls(load_models(path))

    @staticmethod
    def _merge_segmentations(segmentations: list[Segmentation],
                             config: 'SegmentationInferenceConfig') -> Segmentation:
        if len(segmentations) == 1:
            return segmentations[0]
        lines = []
        regions: dict = {}
        script_detection = False
        languages = set()
        region_boundaries = {}
        for seg in segmentations:
            script_detection = script_detection or seg.script_detection
            languages.update(seg.language or [])
            if lines and seg.lines:
                logger.warning('Line output came from more than one model; check your model list.')
            lines.extend(seg.lines)
            for reg_type, regs in seg.regions.items():
                regions.setdefault(reg_type, []).extend(regs)
                for reg in regs:
                    region_boundaries[reg.id] = reg.boundary

        merged_lines = []
        for line in lines:
            containing = [rid for rid, boundary in region_boundaries.items()
                          if _line_midpoint_in_region(line, boundary)]
            merged_lines.append(replace(line, regions=containing))

        if len(ltypes := {type(line) for line in merged_lines}) > 1:
            raise ValueError('A segmentation task cannot mix line data '
                             f'models; got {ltypes}')

        all_regions = [reg for regs in regions.values() for reg in regs]
        if merged_lines:
            ro_fn = (config.baseline_ro_fn if isinstance(merged_lines[0], BaselineLine)
                     else config.bbox_ro_fn)
            order = ro_fn(lines=merged_lines, regions=all_regions,
                          text_direction=segmentations[0].text_direction[-2:])
            merged_lines = [merged_lines[idx] for idx in order]
            seg_type = 'baselines' if isinstance(merged_lines[0], BaselineLine) else 'bbox'
        else:
            seg_type = segmentations[0].type
        return replace(segmentations[0],
                       script_detection=script_detection,
                       language=list(languages),
                       type=seg_type,
                       lines=merged_lines,
                       regions=regions)

    def _compute_additional_line_orders(self, segmentation: Segmentation,
                                        config: 'SegmentationInferenceConfig',
                                        im_size=None) -> Segmentation:
        """
        Would append a neural reading order to `line_orders`; the neural
        reading-order models are not ported yet, so a collection with one
        raises.
        """
        if not self.ro_models:
            return segmentation
        raise NotImplementedError('neural reading order (reading_order models) is not ported '
                                  'yet: ROADMAP.md, queue 1, item 7')
