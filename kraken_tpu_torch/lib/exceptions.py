"""
Compatibility re-export: the reference exposes its exceptions under
kraken.lib.exceptions; kraken_tpu_torch keeps them top-level
(:mod:`kraken_tpu_torch.exceptions`) and mirrors the path.
"""
from kraken_tpu_torch.exceptions import *  # noqa: F401,F403
from kraken_tpu_torch.exceptions import __all__  # noqa: F401
