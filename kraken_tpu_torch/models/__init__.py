from kraken_tpu_torch.models.loaders import load_coreml, load_models, load_safetensors
from kraken_tpu_torch.models.utils import create_model
from kraken_tpu_torch.models.writers import write_models, write_safetensors

__all__ = ['load_models', 'load_safetensors', 'load_coreml', 'create_model',
           'write_models', 'write_safetensors']
