"""
kraken_tpu_torch.parallel
~~~~~~~~~~~~~~~~~~~~~~~~~

Data-parallel training over several cards, one process a card (NCCL), or
over several CPU processes (gloo): the counterpart of the JAX package's
``parallel`` (:mod:`.mesh`), the processes' launcher (:mod:`.launch`) and
``dryrun_multichip`` (:mod:`.dryrun`). Inference over several devices runs
in one process (:func:`make_infer_fn`, the inference configs' ``devices``).
"""
from kraken_tpu_torch.parallel.mesh import (World, inference_devices, init_world, make_infer_fn,
                                            make_train_step, pad_batch_to_multiple,
                                            recorded_steps, replicas, replicate, shard_batch,
                                            shard_rows, world_from_env)

__all__ = ['World', 'init_world', 'world_from_env', 'pad_batch_to_multiple', 'shard_batch',
           'replicate', 'make_train_step', 'recorded_steps', 'inference_devices', 'replicas',
           'shard_rows', 'make_infer_fn']
