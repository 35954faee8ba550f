"""
kraken_tpu_torch
~~~~~~~~~~~~~~~~

The PyTorch/CUDA port of kraken_tpu for NVIDIA Hopper GPUs. It imports
torch, never JAX, and nothing of the ``kraken_tpu`` package: it keeps its
own copies of the host-side code it needs. It covers recognition inference
from a given segmentation (``rpred``, ``mm_rpred``, ``RecognitionTaskModel``,
``VGSLModel.predict``) and BLLA page segmentation (``SegmentationTaskModel``,
``VGSLModel.predict`` on a segmentation model, ``blla.segment``), the two
joined by the streaming page pipeline (``pipeline.process_pages``) and the
``kraken`` inference CLI (``python -m kraken_tpu_torch.kraken``) with its
ALTO/PageXML reader and serializers. It also covers forced alignment
(``ForcedAlignmentTaskModel``) and neural reading order (``ro.ROMLP``
inside ``SegmentationTaskModel``). Entry points run on the card
(``device='cuda'``) unless the caller asks for the CPU.
"""
from kraken_tpu_torch.tasks.recognition import RecognitionTaskModel
from kraken_tpu_torch.tasks.segmentation import SegmentationTaskModel

__all__ = ['RecognitionTaskModel', 'SegmentationTaskModel']

__version__ = '0.1.0'
