"""
Model classes by the name stored in kraken model files. The reference's
name 'TorchVGSLModel' is an alias of :class:`kraken_tpu_torch.vgsl.VGSLModel`
and 'ROMLP' names the reading-order model
(:class:`kraken_tpu_torch.ro.ROMLP`), so files written by either engine
resolve here. Other model classes (pretraining) are not ported yet and
raise ``ValueError``.
"""

__all__ = ['create_model']


def create_model(name: str, **kwargs):
    """Instantiates the model class stored under `name` in a model file."""
    if name in ('TorchVGSLModel', 'VGSLModel'):
        from kraken_tpu_torch.vgsl import VGSLModel
        return VGSLModel(**kwargs)
    if name == 'ROMLP':
        from kraken_tpu_torch.ro.layers import ROMLP
        return ROMLP(**kwargs)
    raise ValueError(f'No model class {name!r} in kraken_tpu_torch')
