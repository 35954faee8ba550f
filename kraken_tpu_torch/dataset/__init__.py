from kraken_tpu_torch.dataset.transforms import ImageInputTransforms

__all__ = ['ImageInputTransforms']
