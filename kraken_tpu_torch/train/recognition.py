"""
kraken_tpu_torch.train.recognition
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Text recognition evaluation, the evaluation half of the JAX package's
``train/recognition.py``: test datasets from XML pages, path pairs or
binary Arrow files, the network forward on the model's device, greedy CTC
decoding, CER/WER and the test report's global alignment and per-script
confusions (``ketos test``).

The forward runs the port's VGSL network inside ``_precise_fp32`` (no
TF32), so on the card the LSTM kernel serves it, and ends in the tail
kernel (``ops/tail.py:recognition_tail``, temperature 1, one launch a
batch): greedy decoding reads only each frame's first maximal class of the
softmax, as the JAX decode takes ``argmax`` of its softmax. A line whose
output has no frame decodes to the empty string.

Training (``setup`` of any stage but 'test', the train loader) waits for
ROADMAP.md queue 1 item 9b and raises ``NotImplementedError``.
"""
import logging
from collections import Counter
from typing import Optional

import numpy as np
import torch

from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.dataset import ImageInputTransforms
from kraken_tpu_torch.dataset.loader import DataLoader, bucket_collate
from kraken_tpu_torch.dataset.recognition import (ArrowIPCRecognitionDataset,
                                                  GroundTruthDataset, PolygonGTDataset)
from kraken_tpu_torch.dataset.utils import compute_confusions, global_align
from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.lib.util import parse_gt_path
from kraken_tpu_torch.ops.ctc import _group_runs
from kraken_tpu_torch.train.metrics import CharErrorRate, WordErrorRate

logger = logging.getLogger(__name__)

__all__ = ['RecognitionModel', 'RecognitionDataModule']

TRAINING_ITEM = 'ROADMAP.md queue 1 item 9b (the training loops)'


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
    Builds the recognition test set from XML pages (or Segmentations of
    baseline pages), path pairs or binary Arrow files.
    """

    def __init__(self, config):
        self.config = config
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

    def setup(self, stage: Optional[str] = None):
        """Builds the test set (`stage` 'test'); other stages train."""
        if stage != 'test':
            raise NotImplementedError(f'setup({stage!r}) trains: {TRAINING_ITEM}')
        cfg = self.config
        split = 'test' if cfg.format_type == 'binary' and cfg.binary_dataset_split else None
        test_ds = self._fill(self._make_dataset(split), cfg.test_data or cfg.evaluation_data)
        self.test_set = _Subset(test_ds, range(len(test_ds)))

    def _loader(self, subset):
        return DataLoader(subset, batch_size=self.config.batch_size, shuffle=False,
                          drop_last=False, collate_fn=bucket_collate,
                          num_workers=self.config.num_workers)

    def train_dataloader(self):
        raise NotImplementedError(f'the training loader: {TRAINING_ITEM}')

    def val_dataloader(self):
        return self._loader(self.val_set)

    def test_dataloader(self):
        return self._loader(self.test_set)


class RecognitionModel:
    """
    CTC recognition module: evaluation of a loaded model on its device
    (``config.device``, in ``config.precision``).
    """

    def __init__(self, config, net=None):
        self.config = config
        self.net = net

    @classmethod
    def load_from_weights(cls, config, path):
        from kraken_tpu_torch.models import load_models
        models = [m for m in load_models(path) if 'recognition' in m.model_type]
        if not models:
            raise ValueError(f'No recognition model found in {path}')
        return cls(config, net=models[0])

    # ------------------------------------------------------------- setup
    def setup(self, stage, datamodule=None):
        """Places the loaded model on the config's device for `stage`
        'test'; other stages train."""
        if stage != 'test':
            raise NotImplementedError(f'setup({stage!r}) trains: {TRAINING_ITEM}')
        if self.net is None:
            raise ValueError('Testing requires a loaded model.')
        from kraken_tpu_torch.inference.recognition import _PRECISION_DTYPES, resolve_device
        self._device = resolve_device(self.config.device)
        self._dtype = _PRECISION_DTYPES.get(self.config.precision, torch.float32)
        self.net.net.to(device=self._device, dtype=self._dtype)
        self.net.net.eval()

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
