from kraken_tpu_torch.ro.features import element_features
from kraken_tpu_torch.ro.layers import ROMLP

__all__ = ['ROMLP', 'element_features']
