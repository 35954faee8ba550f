"""
kraken_tpu_torch.train.recognition
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Text recognition training and evaluation, the counterpart of the JAX
package's ``train/recognition.py`` (the reference's
VGSLRecognitionModel/DataModule, kraken/train/vgsl.py): train and
validation sets from XML pages (or Segmentations of baseline pages), path
pairs or binary Arrow files, with a partition split when no evaluation data
is given; codec negotiation (fail/union/new) through ``resize_output``; the
CTC loss over bucketed padded line batches; validation CER/WER and the test
report's global alignment and per-script confusions (``ketos test``).

Training runs the network in float32 on ``config.device`` with its
parameters trainable, so on the card the LSTM layers run the forward kernel
in its saving mode and the backward kernel (``ops/lstm.py``); ``remat``
re-runs the forward in the backward (``torch.utils.checkpoint``).

Evaluation runs the port's VGSL network inside ``_precise_fp32`` (no TF32),
so on the card the LSTM kernel serves it, and ends in the tail kernel
(``ops/tail.py:recognition_tail``, temperature 1, one launch a batch):
greedy decoding reads only each frame's first maximal class of the
softmax, as the JAX decode takes ``argmax`` of its softmax. A line whose
output has no frame decodes to the empty string.
"""
import logging
from collections import Counter
from typing import Optional

import numpy as np
import torch

from kraken_tpu_torch.codec import Codec
from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.dataset import ImageInputTransforms
from kraken_tpu_torch.dataset.loader import DataLoader, bucket_collate, bucket_dims
from kraken_tpu_torch.dataset.recognition import (ArrowIPCRecognitionDataset,
                                                  GroundTruthDataset, PolygonGTDataset)
from kraken_tpu_torch.dataset.utils import compute_confusions, global_align
from kraken_tpu_torch.exceptions import KrakenEncodeException, KrakenInputException
from kraken_tpu_torch.lib.util import make_printable, parse_gt_path
from kraken_tpu_torch.ops.ctc import _group_runs
from kraken_tpu_torch.train.losses import ctc_loss
from kraken_tpu_torch.train.metrics import CharErrorRate, WordErrorRate
from kraken_tpu_torch.train.trainer import TrainingModule

logger = logging.getLogger(__name__)

__all__ = ['RecognitionModel', 'RecognitionDataModule']


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


class RecognitionDataModule:
    """
    Builds train/validation recognition datasets (and the test set) from XML
    pages (or Segmentations of baseline pages), path pairs or binary Arrow
    files, with a partition split when no explicit evaluation data is given.
    """

    def __init__(self, config):
        self.config = config
        self.use_legacy_polygons = False
        self.train_set = None
        self.val_set = None
        self.test_set = None

    def _make_dataset(self, split_filter=None):
        cfg = self.config
        kwargs = dict(normalization=cfg.normalization,
                      whitespace_normalization=cfg.normalize_whitespace,
                      reorder=cfg.reorder,
                      augmentation=cfg.augment)
        if cfg.format_type == 'binary':
            return ArrowIPCRecognitionDataset(split_filter=split_filter, **kwargs)
        if cfg.format_type in ('xml', 'alto', 'page'):
            return PolygonGTDataset(legacy_polygons=cfg.legacy_polygons, **kwargs)
        if cfg.format_type == 'path':
            return GroundTruthDataset(**kwargs)
        raise ValueError(f'Invalid format type {cfg.format_type}')

    def _fill(self, dataset, files):
        cfg = self.config
        for f in files:
            try:
                if cfg.format_type == 'binary':
                    dataset.add(f)
                elif cfg.format_type in ('xml', 'alto', 'page'):
                    if isinstance(f, Segmentation):
                        page = f
                    else:
                        from kraken_tpu_torch.xml import XMLPage
                        page = XMLPage(f, filetype=cfg.format_type,
                                       linetype=cfg.linetype or 'baselines').to_container()
                    dataset.add(page=page)
                elif cfg.format_type == 'path':
                    dataset.add(line=parse_gt_path(f))
            except (ValueError, KrakenInputException) as e:
                logger.warning(f'Invalid input file {f}: {e}')
        if cfg.format_type == 'binary' and (cfg.normalization or cfg.normalize_whitespace
                                            or cfg.reorder):
            # binary metadata alphabets are pre-transform; recompute through
            # the text transform stack (reference: train/vgsl.py:174-176)
            dataset.rebuild_alphabet()
        return dataset

    def _split(self, name: str) -> Optional[str]:
        cfg = self.config
        return name if cfg.format_type == 'binary' and cfg.binary_dataset_split else None

    def setup(self, stage: Optional[str] = None):
        """Builds the train and validation sets (`stage` 'fit' or None) or
        the test set ('test')."""
        cfg = self.config
        if stage == 'test':
            test_ds = self._fill(self._make_dataset(self._split('test')),
                                 cfg.test_data or cfg.evaluation_data)
            self.test_set = _Subset(test_ds, range(len(test_ds)))
            return
        if cfg.evaluation_data:
            train_ds = self._fill(self._make_dataset(self._split('train')), cfg.training_data)
            val_ds = self._fill(self._make_dataset(self._split('validation')), cfg.evaluation_data)
            self.train_set = _Subset(train_ds, range(len(train_ds)))
            self.val_set = _Subset(val_ds, range(len(val_ds)))
        elif cfg.format_type == 'binary' and cfg.binary_dataset_split:
            train_ds = self._fill(self._make_dataset('train'), cfg.training_data)
            val_ds = self._fill(self._make_dataset('validation'), cfg.training_data)
            self.train_set = _Subset(train_ds, range(len(train_ds)))
            self.val_set = _Subset(val_ds, range(len(val_ds)))
        else:
            ds = self._fill(self._make_dataset(), cfg.training_data)
            indices = np.random.RandomState(42).permutation(len(ds))
            cut = int(len(ds) * cfg.partition)
            self.train_set = _Subset(ds, indices[:cut])
            val_ds = self._fill(self._make_dataset(), cfg.training_data)
            self.val_set = _Subset(val_ds, indices[cut:])
        if isinstance(self.train_set.dataset, PolygonGTDataset):
            self.use_legacy_polygons = cfg.legacy_polygons
        elif isinstance(self.train_set.dataset, ArrowIPCRecognitionDataset):
            # the arrow file's recorded extraction prevails over the request
            # (reference: train/vgsl.py:209-223): its lines were extracted
            # at compile time
            status = self.train_set.dataset.legacy_polygons_status
            val_status = getattr(self.val_set.dataset, 'legacy_polygons_status', status)
            if val_status != status:
                logger.warning('Legacy polygon status differs between train and validation '
                               f'sets ({status} vs {val_status}); keeping the train set status.')
            if status == 'mixed':
                logger.warning('Training data mixes legacy and new polygon extraction; '
                               'recompiling the dataset is recommended.')
                status = False
            if status != cfg.legacy_polygons:
                logger.warning(f'Dataset legacy-polygon mode resolved to {status} '
                               'from the training set (overriding the request).')
            else:
                logger.info(f'Dataset legacy-polygon mode resolved to {status} '
                            'from the training set.')
            self.use_legacy_polygons = bool(status)
        if not len(self.train_set):
            raise ValueError('No valid training data provided.')

    def _loader(self, subset, shuffle: bool = False):
        batch_size = self.config.batch_size
        if shuffle and len(subset) and len(subset) < batch_size:
            # drop_last would otherwise train zero steps an epoch (common
            # with tiny fine-tuning corpora)
            logger.warning(f'Batch size {batch_size} exceeds training set size '
                           f'{len(subset)}; clamping to one full-set batch.')
            batch_size = len(subset)
        return DataLoader(subset, batch_size=batch_size, shuffle=shuffle, drop_last=shuffle,
                          collate_fn=bucket_collate, num_workers=self.config.num_workers,
                          seed=int(np.random.randint(0, 2**31 - 1)) if shuffle else None,
                          dims_fn=bucket_dims)

    def train_dataloader(self):
        return self._loader(self.train_set, True)

    def val_dataloader(self):
        return self._loader(self.val_set)

    def test_dataloader(self):
        return self._loader(self.test_set)


class RecognitionModel(TrainingModule):
    """
    CTC recognition module: training with codec negotiation (in float32 on
    ``config.device``) and evaluation of a model on its device (in
    ``config.precision``).
    """

    def __init__(self, config, net=None):
        self.config = config
        self.net = net
        self._loaded_model = net is not None
        self.trainer = None

    @classmethod
    def load_from_weights(cls, config, path):
        from kraken_tpu_torch.models import load_models
        models = [m for m in load_models(path) if 'recognition' in m.model_type]
        if not models:
            raise ValueError(f'No recognition model found in {path}')
        return cls(config, net=models[0])

    # ------------------------------------------------------------- setup
    def setup(self, stage, datamodule=None):
        """For `stage` 'test' places the loaded model on the config's device
        in its precision; for 'fit' negotiates the codec with the training
        data (or builds a new network from ``config.spec``), wires the
        datasets' transforms and encodings, places the network for training
        and builds :meth:`loss_fn`."""
        if stage == 'test':
            if self.net is None:
                raise ValueError('Testing requires a loaded model.')
            from kraken_tpu_torch.inference.recognition import _PRECISION_DTYPES, resolve_device
            self._device = resolve_device(self.config.device)
            self._dtype = _PRECISION_DTYPES.get(self.config.precision, torch.float32)
            self.net.net.to(device=self._device, dtype=self._dtype)
            self.net_eval()
            return
        cfg = self.config
        train_set = datamodule.train_set.dataset
        data_codec = datamodule.config.codec
        if data_codec is not None and not isinstance(data_codec, Codec):
            data_codec = Codec(data_codec)

        if self.net:
            if cfg.resize == 'new' and data_codec is not None:
                codec = data_codec
            elif self.net.codec is not None:
                codec = self.net.codec
            else:
                raise ValueError('Loaded model carries no usable codec.')
            codec.strict = True
            try:
                train_set.encode(codec)
            except KrakenEncodeException:
                alpha_diff = set(train_set.alphabet).difference(set(codec.c2l.keys()))
                if cfg.resize == 'fail':
                    raise ValueError(f'Model codec does not cover the training alphabet: {alpha_diff}')
                if cfg.resize == 'union':
                    logger.info(f'Growing codec with {len(alpha_diff)} new code points.')
                    codec = codec.add_labels(alpha_diff)
                    self.net.add_codec(codec)
                    self.net.resize_output(codec.max_label + 1)
                    train_set.encode(codec)
                elif cfg.resize == 'new':
                    logger.info(f'Resizing network to {len(train_set.alphabet)} code sequences')
                    train_set.encode(None)
                    codec, del_labels = codec.merge(train_set.codec)
                    self.net.add_codec(codec)
                    self.net.resize_output(codec.max_label + 1, del_labels)
                    train_set.encode(codec)
                else:
                    raise ValueError(f'Unknown codec resize mode {cfg.resize}')
            codec.strict = False
            self.net.add_codec(codec)
            cfg.spec = self.net.spec
        else:
            train_set.encode(data_codec)
            vgsl = cfg.spec.strip()
            cfg.spec = f'[{vgsl[1:-1]} O1c{train_set.codec.max_label + 1}]'
            logger.info(f'Creating new model {cfg.spec} with '
                        f'{train_set.codec.max_label + 1} outputs')
            from kraken_tpu_torch.models import create_model
            self.net = create_model('TorchVGSLModel', model_type=['recognition'], vgsl=cfg.spec)
            self.net.add_codec(train_set.codec)
        for k, v in self.net.codec.c2l.items():
            char = make_printable(k)
            if char == k:
                char = '\t' + char
            logger.debug(f'{char}\t{v}')

        # input transforms from the network's spec (validate() wires the
        # validation set and its codec of placeholder labels)
        batch, channels, height, width = self.net.input
        valid_norm = self.net.seg_type != 'baselines' if self.net.seg_type else True
        train_set.transforms = ImageInputTransforms(batch, height, width, channels,
                                                    pad=(datamodule.config.pad, 0),
                                                    valid_norm=valid_norm)
        if self.net.one_channel_mode and train_set.im_mode != self.net.one_channel_mode:
            logger.warning(f'Model trained on mode {self.net.one_channel_mode} images while '
                           f'the training set is mode {train_set.im_mode}.')
        self.net.user_metadata['metrics'] = []
        self.net.model_type = ['recognition']
        if not self.net.seg_type:
            self.net.seg_type = train_set.seg_type
        # legacy-polygon flag negotiation (reference decision table,
        # train/vgsl.py:565-593): for binary data the dataset's recorded
        # status wins, for extraction on the fly the requested flag
        data_cfg = datamodule.config
        use_legacy = datamodule.use_legacy_polygons
        force_legacy = data_cfg.legacy_polygons
        is_binary = data_cfg.format_type == 'binary'
        desired_legacy = (not is_binary and force_legacy) or use_legacy
        if not self._loaded_model:
            if not is_binary and force_legacy:
                logger.warning('trained model will be marked legacy-polygon')
            elif is_binary:
                if force_legacy and not use_legacy:
                    logger.warning('trained model will be marked new-polygon')
                elif not force_legacy and use_legacy:
                    logger.warning('trained model will be marked legacy-polygon')
        if self._loaded_model and not force_legacy and \
                self.net.use_legacy_polygons and not desired_legacy:
            logger.warning('loaded legacy-polygon model will be re-marked new-polygon')
        self.net.use_legacy_polygons = desired_legacy
        # recorded into checkpoints once samples have been seen (reference:
        # KrakenSetOneChannelMode, kraken/train/utils.py:232)
        self._train_set = train_set
        self._place_for_training()

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """The batch's summed CTC loss over its number of lines (the JAX
        ``loss_fn``), through the network on its device."""
        x = torch.from_numpy(np.ascontiguousarray(batch['image'])).to(self._device, torch.float32)
        lens = torch.from_numpy(np.asarray(batch['seq_lens'], np.int32)).to(self._device)
        logits, olens = self._run(self.net.net, x, lens)
        target = torch.from_numpy(np.asarray(batch['target'])).to(self._device)
        target_lens = torch.from_numpy(np.asarray(batch['target_lens'])).to(self._device)
        return ctc_loss(logits, olens, target, target_lens) / x.shape[0]

    def checkpoint_extras(self) -> dict:
        # single-channel nets record the training images' mode, so that
        # inference picks the matching transform (reference:
        # train/utils.py:232)
        train_set = getattr(self, '_train_set', None)
        if (self.net.one_channel_mode is None and train_set is not None
                and self.net.input[1] == 1 and train_set.im_mode in ('1', 'L')):
            self.net.one_channel_mode = train_set.im_mode
        return {'_seg_type': self.net.seg_type,
                '_one_channel_mode': self.net.one_channel_mode}

    def _forward(self, image: np.ndarray, seq_lens: np.ndarray):
        """Network and tail on the model's device: (N, W) labels, their
        softmax maxima and the output widths, on the host."""
        from kraken_tpu_torch.inference.recognition import _precise_fp32
        from kraken_tpu_torch.ops.tail import recognition_tail
        x = torch.from_numpy(np.ascontiguousarray(image)).to(device=self._device,
                                                             dtype=self._dtype)
        lens = torch.from_numpy(seq_lens.astype(np.int32)).to(self._device)
        with torch.inference_mode(), _precise_fp32(self._dtype):
            logits, olens = self.net.net(x, lens)
            _, labels, confs = recognition_tail(logits, 1.0, probs=False)
        return labels.cpu().numpy(), confs.cpu().numpy(), olens.cpu().numpy()

    # -------------------------------------------------------- evaluation
    def _decode_batch(self, batch, codec) -> list[str]:
        labels, confs, olens = self._forward(batch['image'], batch['seq_lens'])
        return [''.join(x[0] for x in codec.decode(_group_runs(labels[i, :int(n)],
                                                               confs[i, :int(n)])))
                for i, n in enumerate(olens)]

    def _decode_targets(self, batch, codec) -> list[str]:
        texts = []
        for row, length in zip(np.asarray(batch['target']), np.asarray(batch['target_lens'])):
            texts.append(''.join(x[0] for x in codec.decode(
                [(int(lab), 0, 0, 1.0) for lab in row[:int(length)]])))
        return texts

    def _wire(self, dataset, pad: int):
        """Input transforms from the network's spec and a codec with
        placeholder labels for the dataset's unseen code points; encodes
        the dataset with it and returns it."""
        batch, channels, height, width = self.net.input
        valid_norm = self.net.seg_type != 'baselines' if self.net.seg_type else True
        dataset.transforms = ImageInputTransforms(batch, height, width, channels,
                                                  pad=(pad, 0), valid_norm=valid_norm)
        diff = set(dataset.alphabet).difference(set(self.net.codec.c2l.keys()))
        codec = self.net.codec.add_labels(diff)
        dataset.encode(codec)
        return codec

    def validate(self, datamodule) -> dict:
        """CER and WER of the greedy decode over the validation set."""
        codec = self._wire(datamodule.val_set.dataset, datamodule.config.pad)
        cer = CharErrorRate()
        wer = WordErrorRate()
        for batch in datamodule.val_dataloader():
            for p, t in zip(self._decode_batch(batch, codec), self._decode_targets(batch, codec)):
                cer.update(p, t)
                wer.update(p, t)
        return {'val_accuracy': 1 - cer.compute(),
                'val_word_accuracy': 1 - wer.compute(),
                'val_metric': 1 - cer.compute()}

    def test(self, datamodule) -> dict:
        """The test report's numbers: accuracies, character and error
        counts, confusions and per-script totals."""
        codec = self._wire(datamodule.test_set.dataset, datamodule.config.pad)
        cer = CharErrorRate()
        cer_ci = CharErrorRate()
        wer = WordErrorRate()
        confusions = Counter()
        scripts = Counter()
        ins = 0
        dels = Counter()
        subs = Counter()
        for batch in datamodule.test_dataloader():
            preds = self._decode_batch(batch, codec)
            for p, t in zip(preds, self._decode_targets(batch, codec)):
                cer.update(p, t)
                cer_ci.update(p.lower(), t.lower())
                wer.update(p, t)
                _, algn_gt, algn_pred = global_align(t, p)
                c, s, i, d, sb = compute_confusions(algn_gt, algn_pred)
                confusions += c
                scripts += s
                ins += i
                dels += d
                subs += sb
        return {'accuracy': 1 - cer.compute(),
                'case_insensitive_accuracy': 1 - cer_ci.compute(),
                'word_accuracy': 1 - wer.compute(),
                'chars': cer.total,
                'errors': cer.errors,
                'confusions': confusions,
                'scripts': scripts,
                'insertions': ins,
                'deletions': dels,
                'substitutions': subs}
