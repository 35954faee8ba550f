"""
kraken_tpu_torch.parallel
~~~~~~~~~~~~~~~~~~~~~~~~~

Data-parallel training over several cards, one process a card (NCCL), or
over several CPU processes (gloo): the counterpart of the JAX package's
``parallel`` (:mod:`.mesh`), the processes' launcher (:mod:`.launch`) and
``dryrun_multichip`` (:mod:`.dryrun`). The JAX package's ``make_infer_fn``
(inference over a mesh) is not ported, by decision (``PERF.md`` §6).
"""
from kraken_tpu_torch.parallel.mesh import (World, init_world, make_train_step,
                                            pad_batch_to_multiple, recorded_steps, replicate,
                                            shard_batch, world_from_env)

__all__ = ['World', 'init_world', 'world_from_env', 'pad_batch_to_multiple', 'shard_batch',
           'replicate', 'make_train_step', 'recorded_steps']
