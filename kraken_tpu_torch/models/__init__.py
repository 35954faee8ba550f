from kraken_tpu_torch.models.loaders import load_coreml, load_models, load_safetensors
from kraken_tpu_torch.models.utils import create_model

__all__ = ['load_models', 'load_safetensors', 'load_coreml', 'create_model']
