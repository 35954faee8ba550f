"""
kraken_tpu_torch.train.segmentation
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Baseline segmentation training and evaluation, the counterpart of the JAX
package's ``train/segmentation.py`` (the reference's
BLLASegmentationModel/DataModule, kraken/train/blla.py): the BCE + soft
Dice loss on rasterized heatmap targets, the class-mapping resize with
fail/union/new semantics, pixel accuracy and mean IoU of the sigmoid
heatmaps, and baseline-detection P/R/F1 from the vectorizer run on the
predicted heatmaps (``ketos segtrain``/``segtest``).

Training runs the network in float32 on ``config.device`` with its
parameters trainable (on the card its GroupNorm layers run the forward and
backward kernels of ``ops/groupnorm.py``); the loss upsamples the logits to
the target's size with :func:`resize_bilinear`, as the JAX loss resizes
them with ``jax.image.resize``.

Evaluation runs the network inside ``_precise_fp32`` under
``torch.inference_mode()``, then the sigmoid, then a bilinear resize to the
target's size (half-pixel centres, antialiased where it shrinks:
``jax.image.resize(..., 'bilinear')``). The JAX code takes the sigmoid
before the resize, the order the segmentation head kernel reverses, so the
head kernel is not this function. The JAX validation vectorizes with the
host Sato ridge at 0.17; here the ridge kernel
(``ops/ridge.py:sato_ridge_threshold``) thresholds every baseline channel
of a page at 0.17 in one launch, on the model's device.
"""
import logging
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.dataset import ImageInputTransforms
from kraken_tpu_torch.dataset.loader import DataLoader
from kraken_tpu_torch.dataset.segmentation import BaselineSet
from kraken_tpu_torch.train.losses import segmentation_loss
from kraken_tpu_torch.train.metrics import MultilabelAccuracy, MultilabelJaccard
from kraken_tpu_torch.train.trainer import TrainingModule

logger = logging.getLogger(__name__)

__all__ = ['SegmentationModel', 'SegmentationDataModule']

RIDGE_THRESHOLD = 0.17


def _seg_dims(sample: dict) -> tuple:
    return sample['image'].shape + sample['target'].shape


def _seg_collate(batch, dims=None):
    """Pages of one shape stacked; `dims`, the (largest, smallest) page
    shapes over a sharded global batch, must agree, as the pages of one
    batch must."""
    if dims is not None and tuple(dims[0]) != tuple(dims[1]):
        raise ValueError(f'the pages of a batch differ in shape: {tuple(dims[1])} to '
                         f'{tuple(dims[0])}')
    images = np.stack([b['image'] for b in batch])
    targets = np.stack([b['target'] for b in batch])
    return {'image': images, 'target': targets,
            'baselines': [b['baselines'] for b in batch]}


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(N, K, h, w) maps resized to `size` as ``jax.image.resize(...,
    'bilinear')`` resizes them: half-pixel centres, edge taps clamped,
    antialiased on an axis that shrinks."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    shrink = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x, size=size, mode='bilinear', align_corners=False, antialias=shrink)


class SegmentationDataModule:
    """Builds BaselineSet train/validation sets (and the test set) from XML
    pages or Segmentations."""

    def __init__(self, config):
        self.config = config
        self.train_set = None
        self.val_set = None
        self.test_set = None

    def _build(self, pages):
        cfg = self.config
        class_mapping = {'aux': {'_start_separator': 0, '_end_separator': 1},
                         'baselines': cfg.line_class_mapping,
                         'regions': cfg.region_class_mapping}
        # --pad is (left/right, top/bottom); BaselineSet pads (rows, cols)
        lr, tb = cfg.padding
        ds = BaselineSet(class_mapping=class_mapping, augmentation=cfg.augment,
                         line_width=cfg.line_width, padding=(tb, lr))
        for f in pages:
            try:
                if isinstance(f, Segmentation):
                    ds.add(f)
                else:
                    from kraken_tpu_torch.xml import XMLPage
                    ds.add(XMLPage(f, filetype=cfg.format_type
                                   if cfg.format_type in ('alto', 'page', 'xml') else 'xml'
                                   ).to_container())
            except (ValueError, KeyError) as e:
                logger.warning(f'Invalid input file {f}: {e}')
        # freeze auto-assigned mappings into plain dicts
        ds.class_mapping = {k: dict(v) for k, v in ds.class_mapping.items()}
        return ds

    def setup(self, stage: Optional[str] = None):
        """Builds the train and validation sets (`stage` 'fit' or None) or
        the test set ('test')."""
        cfg = self.config
        if stage == 'test':
            self.test_set = self._build(cfg.test_data or cfg.evaluation_data)
            return
        if cfg.evaluation_data:
            self.train_set = self._build(cfg.training_data)
            self.val_set = self._build(cfg.evaluation_data)
        else:
            full = self._build(cfg.training_data)
            n = len(full)
            idx = np.random.RandomState(42).permutation(n)
            cut = max(1, int(n * cfg.partition))
            val = self._build(cfg.training_data)
            self.train_set = _SubsetSeg(full, idx[:cut])
            self.val_set = _SubsetSeg(val, idx[cut:] if n > 1 else idx[:1])
        if not len(self.train_set):
            raise ValueError('No valid training data provided.')

    def train_dataloader(self):
        batch_size = min(self.config.batch_size, max(1, len(self.train_set)))
        if batch_size < self.config.batch_size:
            logger.warning(f'Batch size {self.config.batch_size} exceeds training '
                           f'set size {len(self.train_set)}; clamping.')
        return DataLoader(self.train_set, batch_size=batch_size, shuffle=True, drop_last=True,
                          collate_fn=_seg_collate, num_workers=self.config.num_workers,
                          seed=int(np.random.randint(0, 2**31 - 1)), dims_fn=_seg_dims)

    def val_dataloader(self):
        return DataLoader(self.val_set, batch_size=1, collate_fn=_seg_collate)

    def test_dataloader(self):
        return DataLoader(self.test_set, batch_size=1, collate_fn=_seg_collate)


class _SubsetSeg:
    """Some items of a BaselineSet, with the set's attributes."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


def _base(ds):
    return ds.dataset if isinstance(ds, _SubsetSeg) else ds


class SegmentationModel(TrainingModule):
    """BCE + Dice segmentation module: training (in float32 on
    ``config.device``) and evaluation of a model on its device (in
    ``config.precision``)."""

    def __init__(self, config, net=None):
        self.config = config
        self.net = net
        self.trainer = None

    @classmethod
    def load_from_weights(cls, config, path):
        from kraken_tpu_torch.models import load_models
        models = [m for m in load_models(path) if 'segmentation' in m.model_type]
        if not models:
            raise ValueError(f'No segmentation model found in {path}')
        return cls(config, net=models[0])

    def setup(self, stage, datamodule):
        """For `stage` 'test': places the loaded model on the config's
        device and gives the data module's test and validation sets the
        network's input transforms. For 'fit': builds a new network from
        ``config.spec`` with the training set's classes (or resizes a loaded
        one's output), records the class mapping, wires the transforms and
        places the network for training."""
        if stage == 'test':
            if self.net is None:
                raise ValueError('Testing requires a loaded model.')
            from kraken_tpu_torch.inference.recognition import _PRECISION_DTYPES, resolve_device
            self._device = resolve_device(self.config.device)
            self._dtype = _PRECISION_DTYPES.get(self.config.precision, torch.float32)
            self.net.net.to(device=self._device, dtype=self._dtype)
            self.net_eval()
            sets = (datamodule.test_set, datamodule.val_set)
        else:
            cfg = self.config
            train_set = _base(datamodule.train_set)
            class_mapping = train_set.class_mapping
            num_classes = train_set.num_classes
            if self.net is None:
                spec = cfg.spec.strip()
                cfg.spec = f'[{spec[1:-1]} O2l{num_classes}]'
                from kraken_tpu_torch.models import create_model
                self.net = create_model('TorchVGSLModel', model_type=['segmentation'],
                                        vgsl=cfg.spec)
            else:
                existing = self.net.user_metadata.get('class_mapping', {})
                existing_classes = {k for d in existing.values() for k in d}
                new_classes = {k for d in class_mapping.values() for k in d}
                diff = new_classes - existing_classes
                if diff:
                    if cfg.resize == 'fail':
                        raise ValueError(f'Training data and model class mappings mismatch: {diff}')
                    logger.info(f'Resizing output layer for {len(diff)} new classes.')
                    self.net.resize_output(num_classes)
            self.net.model_type = ['segmentation']
            self.net.seg_type = 'baselines'
            self.net.user_metadata['class_mapping'] = class_mapping
            self.net.user_metadata['topline'] = cfg.topline
            self._place_for_training()
            sets = (datamodule.train_set, datamodule.val_set)
        batch, channels, height, width = self.net.input
        transforms = ImageInputTransforms(batch, height, width, channels, 0, valid_norm=False)
        for ds in sets:
            if ds is not None:
                _base(ds).transforms = transforms

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """BCE + weighted Dice of the logits, upsampled to the target's
        size (the JAX ``loss_fn``), through the network on its device."""
        x = torch.from_numpy(np.ascontiguousarray(batch['image'])).to(self._device, torch.float32)
        target = torch.from_numpy(np.ascontiguousarray(batch['target'])).to(self._device,
                                                                           torch.float32)
        logits, _ = self._run(self.net.net, x)
        logits = resize_bilinear(logits, tuple(target.shape[2:]))
        return segmentation_loss(logits, target, dice_weight=self.config.dice_weight,
                                 world=self.world)

    def checkpoint_extras(self) -> dict:
        return {'_seg_type': 'baselines',
                'class_mapping': self.net.user_metadata.get('class_mapping')}

    def _forward(self, image: np.ndarray, size: tuple[int, int],
                 ridge_channels: tuple) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Network, sigmoid and resize to `size` on the model's device, and
        the thresholded ridge maps of `ridge_channels`: (N, K, H, W) float32
        heatmaps and (N, len(ridge_channels), H, W) bool masks (None
        without channels), on the host."""
        from kraken_tpu_torch.inference.recognition import _precise_fp32
        from kraken_tpu_torch.ops.ridge import sato_ridge_threshold
        x = torch.from_numpy(np.ascontiguousarray(image)).to(device=self._device,
                                                             dtype=self._dtype)
        with torch.inference_mode(), _precise_fp32(self._dtype):
            logits, _ = self.net.net(x, None)
            probs = resize_bilinear(torch.sigmoid(logits.to(torch.float32)), size).contiguous()
            bins = sato_ridge_threshold(probs, ridge_channels, RIDGE_THRESHOLD) \
                if ridge_channels else None
        return probs.cpu().numpy(), None if bins is None else bins.cpu().numpy().astype(bool)

    def validate(self, datamodule, bl_tol: Optional[float] = None) -> dict:
        """Pixel accuracy, mean IoU and (for single-page batches of a model
        with baseline classes) macro-averaged baseline P/R/F1 over the
        validation set."""
        if bl_tol is None:
            bl_tol = self.config.bl_tol
        from kraken_tpu_torch.lib.segmentation_metrics import (aggregate_detection_metrics,
                                                               compute_detection_metrics,
                                                               interpolate_polyline)
        from kraken_tpu_torch.lib.vectorization import vectorize_lines

        acc = MultilabelAccuracy()
        iou = MultilabelJaccard()
        cls_map = self.net.user_metadata.get('class_mapping', {})
        start_idx = cls_map.get('aux', {}).get('_start_separator', 0)
        end_idx = cls_map.get('aux', {}).get('_end_separator', 1)
        bl_idxs = tuple(sorted(set(cls_map.get('baselines', {}).values())))
        bl_metrics = []
        for batch in datamodule.val_dataloader():
            t = batch['target']
            single = bl_idxs and batch['image'].shape[0] == 1 and batch.get('baselines')
            probs, bins = self._forward(batch['image'], t.shape[2:], bl_idxs if single else ())
            acc.update(probs, t)
            iou.update(probs, t)
            if single:
                gt_baselines = batch['baselines'][0]
                pred = probs[0]
                pred_polylines = []
                gt_polylines = []
                for i, cls_idx in enumerate(bl_idxs):
                    stack = np.stack([pred[start_idx], pred[end_idx], pred[cls_idx]])
                    for pl in vectorize_lines(stack, bin_map=bins[0, i]):
                        pred_polylines.append(interpolate_polyline(np.asarray(pl, float)))
                    for bl in gt_baselines.get(cls_idx, []):
                        gt_polylines.append(interpolate_polyline(np.asarray(bl, float)))
                bl_metrics.append(compute_detection_metrics(pred_polylines, gt_polylines, bl_tol))
        result = {'val_accuracy': acc.compute(),
                  'val_mean_iu': iou.compute(),
                  'val_metric': iou.compute()}
        if bl_metrics:
            agg = aggregate_detection_metrics(bl_metrics)
            result.update({'val_bl_precision': agg['precision'],
                           'val_bl_recall': agg['recall'],
                           'val_bl_f1': agg['f1']})
        return result

    def test(self, datamodule) -> dict:
        return self.validate(datamodule)
