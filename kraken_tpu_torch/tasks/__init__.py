from kraken_tpu_torch.tasks.align import ForcedAlignmentTaskModel
from kraken_tpu_torch.tasks.recognition import RecognitionTaskModel
from kraken_tpu_torch.tasks.segmentation import SegmentationTaskModel

__all__ = ['ForcedAlignmentTaskModel', 'RecognitionTaskModel', 'SegmentationTaskModel']
