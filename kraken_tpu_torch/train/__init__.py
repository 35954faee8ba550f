"""
kraken_tpu_torch.train
~~~~~~~~~~~~~~~~~~~~~~

Training and evaluation, the counterparts of the JAX package's training
modules: the losses, the optax-equal optimizers and schedules, checkpoints,
the training loop (:class:`KrakenTrainer`) and the recognition,
segmentation and reading-order task and data modules.
"""
from kraken_tpu_torch.train.checkpoint import (config_from_checkpoint, convert_checkpoint,
                                               load_checkpoint, save_checkpoint)
from kraken_tpu_torch.train.losses import bce_logits_loss, ctc_loss, dice_loss, segmentation_loss
from kraken_tpu_torch.train.optim import Optimizer, build_lr_schedule
from kraken_tpu_torch.train.recognition import RecognitionDataModule, RecognitionModel
from kraken_tpu_torch.train.ro import RODataModule, ROModel
from kraken_tpu_torch.train.segmentation import SegmentationDataModule, SegmentationModel
from kraken_tpu_torch.train.trainer import KrakenTrainer

__all__ = ['ctc_loss', 'bce_logits_loss', 'dice_loss', 'segmentation_loss',
           'Optimizer', 'build_lr_schedule', 'KrakenTrainer',
           'RecognitionModel', 'RecognitionDataModule',
           'SegmentationModel', 'SegmentationDataModule',
           'ROModel', 'RODataModule',
           'save_checkpoint', 'load_checkpoint', 'convert_checkpoint',
           'config_from_checkpoint']
