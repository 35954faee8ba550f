"""
kraken_tpu_torch.blla
~~~~~~~~~~~~~~~~~~~~~

Legacy functional API for the trainable baseline (BLLA) segmenter
(reference: kraken/blla.py), the counterpart of the JAX package's
``blla.py``. Deprecated; use kraken_tpu_torch.tasks.SegmentationTaskModel
for new code. Runs on the card unless the caller passes ``device='cpu'``.
"""
import logging
import warnings
from typing import TYPE_CHECKING, Callable, Literal, Optional

import numpy as np

from kraken_tpu_torch.configs import SegmentationInferenceConfig
from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.exceptions import KrakenInputException, KrakenInvalidModelException
from kraken_tpu_torch.lib.geometry import polygonal_reading_order
from kraken_tpu_torch.tasks.segmentation import SegmentationTaskModel

if TYPE_CHECKING:
    from PIL import Image

logger = logging.getLogger(__name__)

__all__ = ['segment']


def segment(im: 'Image.Image',
            text_direction: Literal['horizontal-lr', 'horizontal-rl',
                                    'vertical-lr', 'vertical-rl'] = 'horizontal-lr',
            mask: Optional[np.ndarray] = None,
            reading_order_fn: Callable = polygonal_reading_order,
            model=None,
            device: str = 'cuda',
            raise_on_error: bool = False,
            autocast: bool = False) -> Segmentation:
    """
    Segments a page into text lines using the baseline segmenter, returning
    reading-order-sorted BaselineLine records with polygonal boundaries.

    Args:
        im: input page image.
        text_direction: principal text direction (heuristic RO hint and
                        orientation fallback).
        mask: bi-level ignore mask (must match image size).
        reading_order_fn: line ordering function.
        model: one or more VGSL segmentation models (default model loaded
               when None).
        device: torch device ('cuda', 'cuda:N' or 'cpu').
        raise_on_error: raise instead of skipping failed lines.
        autocast: run in bf16 mixed precision.
    """
    warnings.warn('`blla.segment()` is deprecated; use `SegmentationTaskModel` instead.',
                  DeprecationWarning)
    if model is None:
        logger.info('Segmentation model not specified; falling back to the default model.')
        task = SegmentationTaskModel.load_model()
    else:
        models = model if isinstance(model, list) else [model]
        for m in models:
            if 'segmentation' not in getattr(m, 'model_type', []):
                raise KrakenInvalidModelException(f'Invalid model type {getattr(m, "model_type", None)} '
                                                  'for segmentation')
            if 'class_mapping' not in m.user_metadata:
                raise KrakenInvalidModelException('Segmentation model without class mapping')
        task = SegmentationTaskModel(models)

    if mask is not None:
        if getattr(mask, 'mode', None) != '1' and not _is_bitonal_mask(mask):
            raise KrakenInputException('Mask is not bitonal')
        if hasattr(mask, 'size') and mask.size != im.size:
            raise KrakenInputException(f'Mask size {mask.size} differs from the page '
                                       f'image size {im.size}')
        logger.warning('Masking is not yet supported by the baseline segmenter; ignoring.')

    config = SegmentationInferenceConfig(text_direction=text_direction,
                                         baseline_ro_fn=reading_order_fn,
                                         device=device,
                                         raise_on_error=raise_on_error,
                                         precision='bf16-true' if autocast else '32-true')
    return task.predict(im, config)


def _is_bitonal_mask(mask) -> bool:
    from kraken_tpu_torch.lib.util import is_bitonal
    try:
        return is_bitonal(mask)
    except Exception:
        return False
