"""
kraken_tpu_torch.registry
~~~~~~~~~~~~~~~~~~~~~~~~~

Cross-cutting registries (reference: kraken/registry.py), the counterpart
of the JAX package's ``registry.py``: the hyperparameter choices the CLIs
offer and ``load_model``, which resolves a weights file into task model
wrappers. The JAX package's ``register_cli_plugins`` (third-party click
commands of the ``kraken.cli``/``ketos.cli`` entry-point groups) is not
ported, by decision (PERF.md §6).
"""
from typing import Optional

__all__ = ['OPTIMIZERS', 'SCHEDULERS', 'STOPPERS', 'PRECISIONS', 'load_model']

OPTIMIZERS = ['Adam', 'AdamW', 'SGD', 'RMSprop', 'Lamb']
SCHEDULERS = ['constant', '1cycle', 'exponential', 'cosine', 'step', 'reduceonplateau']
STOPPERS = ['early', 'fixed']
PRECISIONS = ['64-true', '32-true', 'bf16-true', 'bf16-mixed', '16-true', '16-mixed']


def load_model(path, tasks: Optional[list[str]] = None) -> dict:
    """
    Loads all models in a weights file and wraps them in the task model
    classes their types call for.

    Returns:
        A dict mapping task names ('recognition', 'segmentation') to task
        model instances.
    """
    from kraken_tpu_torch.models import load_models
    models = load_models(path, tasks=tasks)
    wrapped = {}
    types = {t for m in models for t in getattr(m, 'model_type', [])}
    if 'recognition' in types and (tasks is None or 'recognition' in tasks):
        from kraken_tpu_torch.tasks import RecognitionTaskModel
        wrapped['recognition'] = RecognitionTaskModel(models)
    if 'segmentation' in types and (tasks is None or 'segmentation' in tasks):
        from kraken_tpu_torch.tasks import SegmentationTaskModel
        wrapped['segmentation'] = SegmentationTaskModel(models)
    return wrapped
