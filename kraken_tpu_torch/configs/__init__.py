"""
kraken_tpu_torch.configs
~~~~~~~~~~~~~~~~~~~~~~~~

Inference configuration objects (counterparts of the JAX package's
``configs/base.py``). Each config consumes its keyword arguments and passes
the rest up. Inference configs carry injectable function members (the CTC
decoder, the reading-order functions) like the reference.

``device`` names a torch device and defaults to ``'cuda'``: the port runs
on the card unless the caller asks for ``'cpu'``. ``devices`` (both
inference configs, default 1) shards every batch over that many devices in
one process, as the JAX package's 1-D mesh does: one replica of the network
a device, the line or page batch padded to a multiple of N and split into
N contiguous shards, each forwarded on its own device, the results gathered
in order (``parallel/mesh.py:make_infer_fn``). N maps to ``cuda:0`` to
``cuda:N-1`` (fewer visible cards raise), or to N shards on the CPU with
``device='cpu'``. Recognition keeps the JAX package's input routes:
``input_transfer`` ('float', or the byte uploads 'uint8' and 'packed', the
latter rebuilt on the card by the packed gather of ``csrc/extract.cu``) and
``line_extraction`` ('host', or 'device': the gather-warp of
``csrc/extract.cu`` cuts the lines out of the page on the card). Some TPU
knobs have no counterpart: conv/pool fusion and the LSTM backend switch (on
CUDA the recurrence always runs in the port's kernel). Segmentation keeps
the JAX package's link options: ``heatmap_precision`` ('float32', the
default; 'uint8', the heatmaps quantized on the card; 'packbits', the
decision masks bit-packed on the card; 'auto', which probes the upload rate
once), ``input_transfer`` ('float', or 'uint8': the page uploaded as
bytes), ``device_vectorize`` (the page's seam DPs in one launch of the seam
kernel) and ``width_bucketing``, and its ``fused_ridge``: True (the
default) runs the ridge filter and threshold of the baseline channels in
the forward (``csrc/ridge.cu``) and sends back the masks; False sends back
the heatmaps, and vectorization filters them on the host (the port's copy
of ``sato_ridge``) or, with ``device_vectorize``, in the ridge kernel's
response mode (``ops/ridge.py:sato_ridge_device``).
Neither config has ``accelerator`` (``device`` names the device),
``compile`` (XLA compile options; torch runs eagerly) or
``device_pipeline_depth`` (the recognition engine keeps one batch in
flight, the JAX default), nor ``num_threads`` (the CLI's ``--threads``
sizes OpenCV's pool; no config reads it) or ``linetype`` (the XML readers
take the line type as an argument); those keys warn as unknown.

The training and data configs (the JAX package's ``TrainingDataConfig``,
``TrainingConfig`` and their recognition, segmentation and reading-order
subclasses, and the pretraining config) keep the JAX keys and defaults and
serve the training loops and evaluation of :mod:`kraken_tpu_torch.train`,
:mod:`kraken_tpu_torch.pretrain` and ``ketos``. Their ``devices`` is the
number of processes of data-parallel training (``ketos --devices N``, one
a card, :mod:`kraken_tpu_torch.parallel`); the inference configs'
``devices`` shards within one process.
"""
import logging
from collections import defaultdict

__all__ = ['Config', 'RecognitionInferenceConfig', 'SegmentationInferenceConfig',
           'TrainingDataConfig', 'RecognitionTrainingDataConfig',
           'SegmentationTrainingDataConfig', 'TrainingConfig',
           'RecognitionTrainingConfig', 'SegmentationTrainingConfig',
           'ReadingOrderTrainingConfig', 'PretrainingConfig', 'RECOGNITION_SPEC_PRESETS']

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
        input_transfer: 'float' uploads float line batches; 'uint8' uploads
                        them as bytes, divided by 255 on the device;
                        'packed' uploads one dense byte atlas of the lines
                        that the packed gather pads back on the device
        line_extraction: 'host' cuts, dewarps and resizes the lines on the
                         host; 'device' sends each line's sampling grid and
                         the page's bytes, and the gather-warp builds the
                         batch on the device (baseline segmentations of
                         fixed-height one-channel models; others stay on
                         the host)
        devices: shard every line batch over this many devices (one
                 process; ``cuda:0`` to ``cuda:N-1``, or N CPU shards)
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
        self.input_transfer = kwargs.pop('input_transfer', 'float')
        self.line_extraction = kwargs.pop('line_extraction', 'host')
        self.devices = kwargs.pop('devices', 1)
        super().__init__(**kwargs)


class SegmentationInferenceConfig(Config):
    """
    Layout analysis inference configuration.

    Args:
        text_direction: principal text direction
        input_padding: padding around the page before the forward (int,
                       (l/r, t/b) or (l, r, t, b))
        bbox_ro_fn / baseline_ro_fn: injectable reading-order functions
        ridge_threshold: threshold of the ridge response (fused route)
        width_bucketing: pad a single page's width up to a geometric bucket
                     before the forward too (a page batch always is)
        heatmap_precision: what the forward sends back: 'float32' the
                     heatmaps and the ridge masks; 'uint8' the heatmaps as
                     round(p * 255) bytes and the ridge masks; 'packbits'
                     only the masks the host reads (regions > 0.5, the two
                     separator-orientation masks of the 20x20 max-filtered
                     start/end maps, the ridge masks), 8 pixels a byte
                     (needs a baseline class mapping with both separators,
                     else 'uint8'); 'auto' probes the upload rate once and
                     takes 'packbits' below 500 Mbit/s, else 'uint8'
        input_transfer: 'float' uploads the page as floats; 'uint8' as
                     bytes, divided by 255 on the device
        device_vectorize: carve every seam of a page's polygonization in
                     one launch of the seam kernel on the device (the same
                     polygons as the host DP) and, with ``fused_ridge=False``,
                     filter the baseline maps in the ridge kernel's
                     response mode
        fused_ridge: run the ridge filter and threshold of the baseline
                     channels in the forward and send back the masks (the
                     default); False sends back the heatmaps and
                     vectorization filters them, thresholding at
                     ``vectorize_lines``' 0.17 whatever ``ridge_threshold``
                     says, as the JAX package does; 'packbits' then takes
                     'uint8'
        devices: shard every page batch over this many devices (one
                 process; ``cuda:0`` to ``cuda:N-1``, or N CPU shards)
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
        self.width_bucketing = kwargs.pop('width_bucketing', False)
        self.heatmap_precision = kwargs.pop('heatmap_precision', 'float32')
        self.device_vectorize = kwargs.pop('device_vectorize', False)
        self.input_transfer = kwargs.pop('input_transfer', 'float')
        self.fused_ridge = kwargs.pop('fused_ridge', True)
        self.devices = kwargs.pop('devices', 1)
        super().__init__(**kwargs)


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
        training_data / evaluation_data / test_data: input file lists (or
            Segmentations of baseline pages)
        partition: train/validation split when no evaluation data is given
        num_workers: host data-loading threads
        augment: enable augmentation
        batch_size: batch size
    """

    def __init__(self, **kwargs):
        self.training_data = kwargs.pop('training_data', None)
        self.evaluation_data = kwargs.pop('evaluation_data', None)
        self.test_data = kwargs.pop('test_data', None)
        self.partition = kwargs.pop('partition', 0.9)
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
    start/end separator channels), topline flag, line width and page
    padding.
    """

    def __init__(self, **kwargs):
        counter = _Counter(start=1)
        self.format_type = kwargs.pop('format_type', 'xml')
        self.line_class_mapping = kwargs.pop('line_class_mapping', defaultdict(counter))
        self.region_class_mapping = kwargs.pop('region_class_mapping', defaultdict(counter))
        self.topline = kwargs.pop('topline', False)
        self.line_width = kwargs.pop('line_width', 4)
        # (left/right, top/bottom) padding around the page image
        self.padding = kwargs.pop('padding', (0, 0))
        super().__init__(**kwargs)


class RecognitionTrainingDataConfig(TrainingDataConfig):
    """
    Recognition data configuration: format type (xml/path/binary), an
    optional explicit codec, line type filter, binary dataset split flag,
    line padding and the text transforms.
    """

    def __init__(self, **kwargs):
        self.binary_dataset_split = kwargs.pop('binary_dataset_split', False)
        self.format_type = kwargs.pop('format_type', 'xml')
        self.linetype = kwargs.pop('linetype', None)
        self.pad = kwargs.pop('pad', 16)
        self.codec = kwargs.pop('codec', None)
        self.normalization = kwargs.pop('normalization', None)
        self.normalize_whitespace = kwargs.pop('normalize_whitespace', True)
        self.reorder = kwargs.pop('reorder', True)
        self.legacy_polygons = kwargs.pop('legacy_polygons', False)
        super().__init__(**kwargs)


# named VGSL presets accepted wherever a spec is (`-s tpu`), the JAX
# package's: 'default' is the reference's CNN+3xBiLSTM-200, 'tpu' strided
# 128-channel convolutions with GroupNorm, 'tpu-attn' rotary-attention
# encoder blocks instead of the BiLSTMs
RECOGNITION_SPEC_PRESETS = {
    'default': ('[1,120,0,1 Cr3,13,32 Do0.1,2 Mp2,2 Cr3,13,32 Do0.1,2 Mp2,2 '
                'Cr3,9,64 Do0.1,2 Mp2,2 Cr3,9,64 Do0.1,2 S1(1x0)1,3 Lbx200 '
                'Do0.1,2 Lbx200 Do0.1,2 Lbx200 Do]'),
    'tpu': ('[1,120,0,1 Cr3,7,128,2,2 Gn32 Cr3,7,128,2,2 Gn32 '
            'Cr3,7,128,2,2 Gn32 S1(1x0)1,3 Lbx200 Do0.1,2 Lbx200 Do0.1,2 '
            'Lbx200 Do]'),
    'tpu-attn': ('[1,120,0,1 S1(30x4)1,3 Cr3,13,32 Do0.1,2 Mp2,2 '
                 'Cr3,13,32 Do0.1,2 Mp2,2 Cr3,9,64 Do0.1,2 Mp2,2 '
                 'Cr3,9,64 Do0.1,2 S1(1x0)1,3 Cl1,1,256 Te8,256,1024 '
                 'Te8,256,1024 Te8,256,1024 Te8,256,1024 Do0.1,2]'),
}

SEGMENTATION_SPEC = ('[1,1800,0,3 Cr7,7,64,2,2 Gn32 Cr3,3,128,2,2 Gn32 Cr3,3,128 Gn32 '
                     'Cr3,3,256 Gn32]')


class TrainingConfig(Config):
    """
    Generic training configuration: optimizer, schedule, early stopping,
    checkpointing (reference: configs/base.py:288-376), with the JAX
    package's keys and defaults. Training runs in float32 whatever
    ``precision`` says, as the JAX training does.
    """

    def __init__(self, **kwargs):
        # the processes of data-parallel training (ketos --devices N)
        self.devices = kwargs.pop('devices', 1)
        self.epochs = kwargs.pop('epochs', -1)
        self.completed_epochs = kwargs.pop('completed_epochs', 0)
        self.freq = kwargs.pop('freq', 1.0)
        self.checkpoint_path = kwargs.pop('checkpoint_path', 'model')
        self.weights_format = kwargs.pop('weights_format', 'safetensors')
        self.optimizer = kwargs.pop('optimizer', 'AdamW')
        self.lrate = kwargs.pop('lrate', 1e-5)
        self.momentum = kwargs.pop('momentum', 0.9)
        self.weight_decay = kwargs.pop('weight_decay', 0.0)
        self.gradient_clip_val = kwargs.pop('gradient_clip_val', 1.0)
        self.accumulate_grad_batches = kwargs.pop('accumulate_grad_batches', 1)
        self.schedule = kwargs.pop('schedule', 'constant')
        self.warmup = kwargs.pop('warmup', 0)
        self.step_size = kwargs.pop('step_size', 10)
        self.gamma = kwargs.pop('gamma', 0.1)
        self.rop_factor = kwargs.pop('rop_factor', 0.1)
        self.rop_patience = kwargs.pop('rop_patience', 5)
        self.cos_t_max = kwargs.pop('cos_t_max', 10)
        self.cos_min_lr = kwargs.pop('cos_min_lr', 1e-6)
        self.quit = kwargs.pop('quit', 'fixed')
        # the K best epoch checkpoints by validation metric stay
        # (reference: ModelCheckpoint(save_top_k=10)); <= 0 keeps all
        self.save_top_k = kwargs.pop('save_top_k', 10)
        self.min_epochs = kwargs.pop('min_epochs', 0)
        self.lag = kwargs.pop('lag', 10)
        self.min_delta = kwargs.pop('min_delta', 0.0)
        # re-run the forward in the backward (torch.utils.checkpoint)
        self.remat = kwargs.pop('remat', False)
        # experiment logger ('tensorboard', 'wandb' or None) and a
        # torch.profiler trace directory for the first epoch
        self.loggers = kwargs.pop('loggers', None)
        self.profile_dir = kwargs.pop('profile_dir', None)
        super().__init__(**kwargs)


class RecognitionTrainingConfig(TrainingConfig):
    """Recognition-specific training configuration."""

    def __init__(self, **kwargs):
        spec = kwargs.pop('spec', 'default')
        self.spec = RECOGNITION_SPEC_PRESETS.get(spec, spec)
        self.append = kwargs.pop('append', None)
        self.resize = kwargs.pop('resize', 'fail')
        # all but the output layer frozen for the first N steps
        self.freeze_backbone = kwargs.pop('freeze_backbone', 0)
        kwargs.setdefault('lrate', 1e-3)
        kwargs.setdefault('optimizer', 'AdamW')
        super().__init__(**kwargs)


class SegmentationTrainingConfig(TrainingConfig):
    """Segmentation-specific training configuration."""

    def __init__(self, **kwargs):
        self.spec = kwargs.pop('spec', SEGMENTATION_SPEC)
        self.resize = kwargs.pop('resize', 'fail')
        self.topline = kwargs.pop('topline', False)
        self.dice_weight = kwargs.pop('dice_weight', 0.5)
        # tolerance (px) for baseline-detection validation matching
        self.bl_tol = kwargs.pop('bl_tol', 25.0)
        kwargs.setdefault('lrate', 2e-4)
        super().__init__(**kwargs)


class ReadingOrderTrainingConfig(TrainingConfig):
    """Reading-order model training configuration."""

    def __init__(self, **kwargs):
        self.level = kwargs.pop('level', 'baselines')
        self.reading_order = kwargs.pop('reading_order', 'line_implicit')
        kwargs.setdefault('lrate', 1e-3)
        super().__init__(**kwargs)


class PretrainingConfig(TrainingConfig):
    """Wav2Vec2-style pretraining configuration: the default spec is the
    flagship recognizer's backbone with a ``W`` block before its recurrent
    stack (the block is stripped before training: the pretraining module
    does the masking)."""

    def __init__(self, **kwargs):
        self.spec = kwargs.pop('spec', '[1,120,0,1 Cr3,13,32 Do0.1,2 Mp2,2 Cr3,13,32 Do0.1,2 Mp2,2 '
                                       'Cr3,9,64 Do0.1,2 Mp2,2 Cr3,9,64 Do0.1,2 S1(1x0)1,3 '
                                       'W{w2v}128,2,0.115,32 Lbx200 Do0.1,2 Lbx200 Do0.1,2 Lbx200 Do]')
        self.mask_width = kwargs.pop('mask_width', 4)
        self.mask_prob = kwargs.pop('mask_prob', 0.5)
        self.num_negatives = kwargs.pop('num_negatives', 100)
        self.logit_temp = kwargs.pop('logit_temp', 0.1)
        super().__init__(**kwargs)
