"""
kraken_tpu_torch.train
~~~~~~~~~~~~~~~~~~~~~~

The evaluation halves of the JAX package's training modules: recognition
and segmentation data modules and models that test a loaded model
(``ketos test``/``segtest``), and their metrics. The training loops,
losses, optimizers and checkpoints wait for ROADMAP.md queue 1 item 9b.
"""
from kraken_tpu_torch.train.recognition import RecognitionDataModule, RecognitionModel
from kraken_tpu_torch.train.segmentation import SegmentationDataModule, SegmentationModel

__all__ = ['RecognitionModel', 'RecognitionDataModule',
           'SegmentationModel', 'SegmentationDataModule']
