"""
kraken_tpu_torch.parallel.dryrun
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

``dryrun_multichip(n)``, the counterpart of the JAX package's driver entry
point (``__graft_entry__.py:dryrun_multichip``, its parts 1 and 3): one
data-parallel recognition training step (CTC and AdamW) and one
data-parallel segmentation training step (BCE and Dice) on tiny shapes, on
n ranks, each printing its loss from rank 0; every rank must hold the same
parameters after each step. The ranks run in new processes: NCCL on n
cards where n are visible, else gloo on the CPU (the JAX function's
virtual CPU mesh). Its parts 2 and 4 (inference over a mesh) are not
ported, by decision.

    python -m kraken_tpu_torch.parallel.dryrun N
"""
import sys

import numpy as np
import torch

__all__ = ['dryrun_multichip']

REC_SPEC = '[1,32,0,1 Cr3,3,8,2,2 Do0.1,2 Mp2,2 S1(1x0)1,3 Lbx16 Do0.1,2 O1c12]'
SEG_SPEC = '[1,32,0,3 Cr3,3,8,2,2 Gn2 Cr3,3,8,2,2 Gn2 O2l4]'
TIMEOUT_S = 600


def dryrun_multichip(n_devices: int) -> None:
    """Runs the two data-parallel steps on `n_devices` ranks, each in a new
    process (NCCL where the cards are visible, else gloo on the CPU); raises
    if a rank fails."""
    from kraken_tpu_torch.parallel.launch import free_port, start_ranks
    device = 'cuda' if torch.cuda.is_available() and \
        torch.cuda.device_count() >= n_devices else 'cpu'
    start_ranks(['-m', 'kraken_tpu_torch.parallel.dryrun', str(n_devices), device],
                n_devices, range(n_devices), free_port()).wait(TIMEOUT_S)


def _replicated(world, params) -> bool:
    """Whether every rank holds rank 0's parameters."""
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    first = flat.clone()
    torch.distributed.broadcast(first, src=0)
    same = torch.tensor([float(torch.equal(flat, first))], device=flat.device)
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    return bool(same.item())


def _rank_main(n_devices: int, device: str) -> None:
    """One rank of the dry run (RANK etc. from the environment)."""
    from kraken_tpu_torch.configs import RecognitionTrainingConfig, SegmentationTrainingConfig
    from kraken_tpu_torch.parallel import make_train_step, replicate, shard_batch, world_from_env
    from kraken_tpu_torch.train import Optimizer, RecognitionModel, SegmentationModel
    from kraken_tpu_torch.vgsl import VGSLModel
    world = world_from_env(device)
    try:
        batch_size = 2 * n_devices
        rng = np.random.RandomState(0)

        def step(module, batch, tag):
            module.world = world
            module._place_for_training()
            replicate(world, module.parameters())
            module.generator = torch.Generator(device=world.device).manual_seed(1 + world.rank)
            optimizer = Optimizer(module.parameters(), module.config, 1)
            loss = make_train_step(module, optimizer, world)(shard_batch(batch, world))
            loss = world.mean(loss)
            if not np.isfinite(loss):
                raise RuntimeError(f'non-finite {tag} loss {loss}')
            if not _replicated(world, module.parameters()):
                raise RuntimeError(f'the ranks disagree on the parameters after the {tag} step')
            if world.is_main:
                print(f'dryrun_multichip({n_devices}): one DP {tag} train step OK on '
                      f'{world.backend}, loss={loss:.4f}', flush=True)

        # 1. recognition: CTC + AdamW
        config = RecognitionTrainingConfig(lrate=1e-3, warmup=2, device=str(world.device))
        rec = RecognitionModel(config, net=VGSLModel(
            REC_SPEC, generator=torch.Generator().manual_seed(world.rank)))
        step(rec, {'image': rng.rand(batch_size, 1, 32, 64).astype(np.float32),
                   'seq_lens': np.full((batch_size,), 64, np.int32),
                   'target': rng.randint(1, 12, size=(batch_size, 5)).astype(np.int32),
                   'target_lens': np.full((batch_size,), 5, np.int32)}, 'recognition')
        # 3. segmentation: BCE + soft Dice on page heatmaps (two stride-2
        # convolutions on 32x32 pages)
        seg_config = SegmentationTrainingConfig(lrate=1e-3, warmup=2, device=str(world.device))
        seg = SegmentationModel(seg_config, net=VGSLModel(
            SEG_SPEC, generator=torch.Generator().manual_seed(2 + world.rank)))
        step(seg, {'image': rng.rand(batch_size, 3, 32, 32).astype(np.float32),
                   'target': (rng.rand(batch_size, 4, 8, 8) > 0.5).astype(np.float32)},
             'segmentation')
    finally:
        world.close()


if __name__ == '__main__':
    import os
    if 'RANK' in os.environ:
        _rank_main(int(sys.argv[1]), sys.argv[2])
    else:
        dryrun_multichip(int(sys.argv[1]))
