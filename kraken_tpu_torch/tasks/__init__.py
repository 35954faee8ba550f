from kraken_tpu_torch.tasks.recognition import RecognitionTaskModel

__all__ = ['RecognitionTaskModel']
