"""
kraken_tpu_torch.configs
~~~~~~~~~~~~~~~~~~~~~~~~

Inference configuration objects (counterparts of the JAX package's
``configs/base.py``). Each config consumes its keyword arguments and passes
the rest up. Inference configs carry injectable function members (the CTC
decoder, the reading-order functions) like the reference.

``device`` names a torch device and defaults to ``'cuda'``: the port runs
on the card unless the caller asks for ``'cpu'``. The JAX package's TPU
knobs (byte or packed input transfer, device line extraction, conv/pool
fusion, the LSTM backend switch, multi-device meshes) have no counterpart:
on CUDA the recurrence always runs in the port's kernel. Segmentation has
none of the JAX package's link knobs either (``heatmap_precision``
'auto'/'uint8'/'packbits', ``input_transfer='uint8'``, ``device_vectorize``,
``devices>1``): the port always brings the float32 heatmaps back, the
JAX default. Nor has it ``width_bucketing`` (a single page runs at its own
width; only a page batch is padded to a common bucket) or ``fused_ridge``
(the ridge filter of the baseline channels always runs in the forward).
"""

__all__ = ['Config', 'RecognitionInferenceConfig', 'SegmentationInferenceConfig']


class Config:
    """
    Base configuration.

    Args:
        precision: numerical precision for inference ('32-true',
                   'bf16-true', 'bf16-mixed', '16-true', ...)
        device: torch device to run on ('cuda', 'cuda:N' or 'cpu')
        batch_size: batch size for all operations
        raise_on_error: raise exceptions instead of skipping failed inputs
    """

    def __init__(self, **kwargs):
        self.precision = kwargs.pop('precision', '32-true')
        self.device = kwargs.pop('device', 'cuda')
        self.batch_size = kwargs.pop('batch_size', 1)
        self.raise_on_error = kwargs.pop('raise_on_error', False)
        if kwargs:
            import logging
            logging.getLogger(__name__).warning(f'Ignoring unknown configuration parameters: {sorted(kwargs)}')

    def __repr__(self):
        return f'{type(self).__name__}({vars(self)})'


class RecognitionInferenceConfig(Config):
    """
    Text recognition inference configuration.

    Args:
        temperature: softmax temperature applied to logits
        return_logits: attach raw logits to emitted records
        return_line_image: attach the extracted line image to records
        padding: horizontal padding added around extracted lines
        num_line_workers: host workers for parallel line extraction
        no_legacy_polygons: force the new polygon extractor
        decoder: CTC decoding function (softmax outputs → label runs)
        bidi_reordering: reorder output into logical order via UAX #9;
                         'L'/'R' force a base direction
        text_direction: principal text direction for serialization
    """

    def __init__(self, **kwargs):
        from kraken_tpu_torch.ops import ctc
        self.temperature = kwargs.pop('temperature', 1.0)
        self.return_logits = kwargs.pop('return_logits', False)
        self.return_line_image = kwargs.pop('return_line_image', False)
        self.padding = kwargs.pop('padding', 16)
        self.num_line_workers = kwargs.pop('num_line_workers', 2)
        self.no_legacy_polygons = kwargs.pop('no_legacy_polygons', False)
        self.decoder = kwargs.pop('decoder', ctc.greedy_decoder)
        self.bidi_reordering = kwargs.pop('bidi_reordering', True)
        self.text_direction = kwargs.pop('text_direction', 'horizontal-tb')
        super().__init__(**kwargs)


class SegmentationInferenceConfig(Config):
    """
    Layout analysis inference configuration.

    Args:
        text_direction: principal text direction
        input_padding: padding around the page before the forward (int,
                       (l/r, t/b) or (l, r, t, b))
        bbox_ro_fn / baseline_ro_fn: injectable reading-order functions
        ridge_threshold: threshold of the ridge response
        legacy_*, bbox_line_padding: parameters of the legacy bbox page
                     segmenter, stored only (that segmenter is not ported)
    """

    def __init__(self, **kwargs):
        from kraken_tpu_torch.lib import geometry
        self.text_direction = kwargs.pop('text_direction', 'horizontal-lr')
        self.legacy_scale = kwargs.pop('legacy_scale', None)
        self.legacy_maxcolseps = kwargs.pop('legacy_maxcolseps', 2)
        self.legacy_black_colseps = kwargs.pop('legacy_black_colseps', False)
        self.legacy_no_hlines = kwargs.pop('legacy_no_hlines', True)
        self.bbox_line_padding = kwargs.pop('bbox_line_padding', 0)
        self.input_padding = kwargs.pop('input_padding', 0)
        self.bbox_ro_fn = kwargs.pop('bbox_ro_fn', geometry.reading_order)
        self.baseline_ro_fn = kwargs.pop('baseline_ro_fn', geometry.polygonal_reading_order)
        self.ridge_threshold = kwargs.pop('ridge_threshold', 0.17)
        super().__init__(**kwargs)
