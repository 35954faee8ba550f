from kraken_tpu_torch.tasks.recognition import RecognitionTaskModel
from kraken_tpu_torch.tasks.segmentation import SegmentationTaskModel

__all__ = ['RecognitionTaskModel', 'SegmentationTaskModel']
