"""
kraken_tpu_torch.pretrain
~~~~~~~~~~~~~~~~~~~~~~~~~

Wav2Vec2-style masked contrastive pretraining of recognition backbones, the
counterpart of the JAX package's ``pretrain`` package: the ``W`` VGSL
block's masking layer (:mod:`.layers`), the training module that ``ketos
pretrain`` and ``KrakenTrainer.fit`` drive and its data module (:mod:`.model`).
"""
from kraken_tpu_torch.pretrain.layers import Wav2Vec2Mask, compute_mask_indices, span_mask
from kraken_tpu_torch.pretrain.model import PretrainDataModule, RecognitionPretrainModel

__all__ = ['PretrainDataModule', 'RecognitionPretrainModel', 'Wav2Vec2Mask', 'compute_mask_indices', 'span_mask']
