"""
kraken_tpu_torch.tasks.recognition
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

High-level recognition task wrapper (reference: kraken/tasks/recognition.py):
selects the recognition model from a loaded model collection and streams OCR
records for a segmented page.
"""
import logging
from typing import TYPE_CHECKING, Union

from kraken_tpu_torch.models import load_models

if TYPE_CHECKING:
    from os import PathLike
    from PIL import Image
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.containers import Segmentation

logger = logging.getLogger(__name__)

__all__ = ['RecognitionTaskModel']


class RecognitionTaskModel:
    """
    Wrapper around a text recognition model.

    Raises:
        ValueError: when no recognition model is in the collection.
    """

    def __init__(self, models: list):
        models = [net for net in models if 'recognition' in net.model_type]
        if not models:
            raise ValueError(f'Model list contains no recognition model: {models}.')
        if len(models) > 1:
            logger.warning('Multiple recognition models supplied; only the first is used.')
        self.net = models[0]
        self.one_channel_mode = self.net.one_channel_mode
        self.seg_type = self.net.seg_type

    def predict(self, im: 'Image.Image', segmentation: 'Segmentation',
                config: 'RecognitionInferenceConfig'):
        """
        Streams one ocr_record per line of the segmentation, on the device
        of `config` (the card unless it says 'cpu').
        """
        if config.precision in ('bf16-true', '16-true'):
            logger.warning(f'Requested float precision {config.precision} is fixed length '
                           '16 bit and may cause unstable recognition.')
        self.net.prepare_for_inference(config)
        return self.net.predict(im, segmentation)

    @classmethod
    def load_model(cls, path: Union[str, 'PathLike']) -> 'RecognitionTaskModel':
        return cls(load_models(path))
