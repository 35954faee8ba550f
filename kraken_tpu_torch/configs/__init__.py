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
Nor has it ``accelerator`` (``device`` names the device), ``compile``
(XLA compile options; torch runs eagerly) or ``device_pipeline_depth``
(the recognition engine keeps one batch in flight, the JAX default), nor
``num_threads`` (the CLI's ``--threads`` sizes OpenCV's pool; no config
reads it) or ``linetype`` (the XML readers take the line type as an
argument); those keys warn as unknown.

The training and data configs (the JAX package's ``TrainingDataConfig``,
``TrainingConfig`` and their recognition and segmentation subclasses)
serve evaluation for now: ``ketos test``/``segtest`` and the evaluation
halves of :mod:`kraken_tpu_torch.train`. The keys only a training loop
reads (optimizer, schedule, stopping, checkpointing, the spec and resize
of a new model, the training files and split) have no consumer until
ROADMAP.md queue 1 item 9b, and ``devices`` none until item 10 (multi-GPU):
given, they warn with the item's name and are dropped.
"""
import logging
from collections import defaultdict

__all__ = ['Config', 'RecognitionInferenceConfig', 'SegmentationInferenceConfig',
           'TrainingDataConfig', 'RecognitionTrainingDataConfig',
           'SegmentationTrainingDataConfig', 'TrainingConfig',
           'RecognitionTrainingConfig', 'SegmentationTrainingConfig']

logger = logging.getLogger(__name__)


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
            logger.warning(f'Ignoring unknown configuration parameters: {sorted(kwargs)}')

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
                     segmenter (``pageseg.segment``)
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


# keys of the JAX package's training configs that nothing in the port reads
# yet, by the ROADMAP.md queue 1 item that brings their consumer
_DEFERRED = {
    '9b (the training loops)': (
        'training_data', 'partition', 'codec', 'epochs', 'completed_epochs', 'freq',
        'checkpoint_path', 'weights_format', 'optimizer', 'lrate', 'momentum',
        'weight_decay', 'gradient_clip_val', 'accumulate_grad_batches', 'schedule',
        'warmup', 'step_size', 'gamma', 'rop_factor', 'rop_patience', 'cos_t_max',
        'cos_min_lr', 'quit', 'save_top_k', 'min_epochs', 'lag', 'min_delta', 'remat',
        'loggers', 'profile_dir', 'spec', 'append', 'resize', 'freeze_backbone',
        'topline', 'dice_weight'),
    '10 (multi-GPU)': ('devices',),
}


def _drop_deferred(kwargs: dict, keys: tuple) -> None:
    """Pops the deferred keys among `keys` from `kwargs`, warning with the
    ROADMAP item that brings their consumer."""
    for item, deferred in _DEFERRED.items():
        given = sorted(k for k in keys if k in deferred and k in kwargs)
        for k in given:
            kwargs.pop(k)
        if given:
            logger.warning(f'Ignoring configuration parameters {given}: nothing reads them '
                           f'until ROADMAP.md queue 1 item {item}')


class _Counter:
    """Stateful counter for auto-assigned class mapping labels."""

    def __init__(self, start=0):
        self.value = start

    def __call__(self):
        self.value += 1
        return self.value


class TrainingDataConfig:
    """
    Generic training data configuration.

    Args:
        evaluation_data / test_data: input file lists
        num_workers: host data-loading threads
        augment: enable augmentation
        batch_size: batch size
    """

    def __init__(self, **kwargs):
        _drop_deferred(kwargs, ('training_data', 'partition', 'codec'))
        self.evaluation_data = kwargs.pop('evaluation_data', None)
        self.test_data = kwargs.pop('test_data', None)
        self.num_workers = kwargs.pop('num_workers', 1)
        self.augment = kwargs.pop('augment', False)
        self.batch_size = kwargs.pop('batch_size', 1)
        if kwargs:
            logger.warning(f'Ignoring unknown configuration parameters: {sorted(kwargs)}')

    def __repr__(self):
        return f'{type(self).__name__}({vars(self)})'


class SegmentationTrainingDataConfig(TrainingDataConfig):
    """
    Segmentation data configuration: format type, line/region class
    mappings (auto-assigning by default; labels 0/1 are reserved for the
    start/end separator channels), line width and page padding.
    """

    def __init__(self, **kwargs):
        counter = _Counter(start=1)
        self.format_type = kwargs.pop('format_type', 'xml')
        self.line_class_mapping = kwargs.pop('line_class_mapping', defaultdict(counter))
        self.region_class_mapping = kwargs.pop('region_class_mapping', defaultdict(counter))
        self.line_width = kwargs.pop('line_width', 4)
        # (left/right, top/bottom) padding around the page image
        self.padding = kwargs.pop('padding', (0, 0))
        _drop_deferred(kwargs, ('topline',))
        super().__init__(**kwargs)


class RecognitionTrainingDataConfig(TrainingDataConfig):
    """
    Recognition data configuration: format type (xml/path/binary), line
    type filter, binary dataset split flag, line padding and the text
    transforms.
    """

    def __init__(self, **kwargs):
        self.binary_dataset_split = kwargs.pop('binary_dataset_split', False)
        self.format_type = kwargs.pop('format_type', 'xml')
        self.linetype = kwargs.pop('linetype', None)
        self.pad = kwargs.pop('pad', 16)
        self.normalization = kwargs.pop('normalization', None)
        self.normalize_whitespace = kwargs.pop('normalize_whitespace', True)
        self.reorder = kwargs.pop('reorder', True)
        self.legacy_polygons = kwargs.pop('legacy_polygons', False)
        super().__init__(**kwargs)


class TrainingConfig(Config):
    """Generic training configuration: so far its device, precision and
    batch size (the training keys wait for queue 1 item 9b)."""

    def __init__(self, **kwargs):
        _drop_deferred(kwargs, tuple(k for keys in _DEFERRED.values() for k in keys))
        super().__init__(**kwargs)


class RecognitionTrainingConfig(TrainingConfig):
    """Recognition-specific training configuration."""


class SegmentationTrainingConfig(TrainingConfig):
    """Segmentation-specific training configuration."""

    def __init__(self, **kwargs):
        # tolerance (px) for baseline-detection validation matching
        self.bl_tol = kwargs.pop('bl_tol', 25.0)
        super().__init__(**kwargs)
