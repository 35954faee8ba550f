"""
kraken_tpu_torch.parallel.mesh
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Data-parallel training over several processes, one a card, the counterpart
of the JAX package's ``parallel/mesh.py`` (a 1-D mesh over the batch axis):
parameters and optimizer state are replicated, a batch is padded to a
multiple of the world size by repeating its first samples and sharded on its
leading dimension, and the gradients are summed over the ranks after the
backward and divided by the world size before the optimizer step. So with N
ranks a step computes the update that one process computes on the padded
global batch, up to the order of the sums.

Where XLA inserts the gradient all-reduce into the jitted step,
:meth:`World.all_reduce_grads` runs it after ``loss.backward()``: flat
buckets of about 25 MB over the trainer's fixed-order parameters, as DDP
buckets them. ``DistributedDataParallel`` is not used: it wraps one module,
and pretraining's ``mask_emb`` and ``project_q`` live outside the network.

Processes meet through ``torch.distributed`` at a TCP address on the
loopback: NCCL between cards (rank r on ``cuda:r``), gloo on the CPU. Beside
NCCL a gloo group carries the host's small messages (loader states, padded
widths, seeds, stop decisions), so that they never wait behind the card's
queue. A failed collective raises; nothing carries on with fewer ranks.

Inference over several devices runs in one process, as the JAX package's
``make_infer_fn`` runs over its mesh: :func:`inference_devices` names the
devices of a config's ``devices``, :func:`replicas` keeps one copy of the
network a device, and :func:`make_infer_fn` pads a line batch to a
multiple of the device count, forwards one contiguous shard on each device
and gathers the results in order (the recognition and segmentation engines
shard their batches the same way, with their own input routes).
"""
import copy
import datetime
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['World', 'init_world', 'world_from_env', 'pad_batch_to_multiple', 'shard_batch',
           'replicate', 'make_train_step', 'recorded_steps', 'BUCKET_BYTES',
           'inference_devices', 'replicas', 'shard_rows', 'make_infer_fn']

# the gradient all-reduce's flat buckets (DDP's default bucket_cap_mb)
BUCKET_BYTES = 25 * 2**20
# how long a rank waits for the others in a collective (a rank that
# validates keeps the others waiting for that long)
TIMEOUT_S = 1800


@dataclass
class World:
    """A rank's view of the process group: its rank, the world size, its
    device and backend, and the group for the host's messages."""

    rank: int
    size: int
    device: torch.device
    backend: str
    host_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a batch of `n` (a multiple of the
        world size)."""
        if n % self.size:
            raise ValueError(f'a batch of {n} does not split over {self.size} ranks')
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s `obj` on every rank (over the host group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        return box[0]

    def extrema(self, hi: np.ndarray, lo: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The elementwise maximum of `hi` and minimum of `lo` over the ranks
        (integers, over the host group)."""
        both = torch.from_numpy(np.concatenate([np.asarray(hi, np.int64),
                                                -np.asarray(lo, np.int64)]))
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.host_group)
        both = both.numpy()
        return both[:len(hi)], -both[len(hi):]

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sums `tensor` over the ranks in place (on its device)."""
        dist.all_reduce(tensor)
        return tensor

    def mean(self, value: torch.Tensor) -> float:
        """The mean of a scalar tensor over the ranks."""
        total = value.detach().clone().reshape(1)
        dist.all_reduce(total)
        return float(total) / self.size

    def all_reduce_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Replaces each parameter's gradient by its mean over the ranks:
        flat buckets of about BUCKET_BYTES (of one dtype) in the parameters'
        order, summed, then divided by the world size. A parameter without a
        gradient (one the loss does not reach) has none on any rank and
        stays without."""
        grads = [p.grad for p in params if p.grad is not None]
        for bucket in _buckets(grads, BUCKET_BYTES):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat)
            flat.div_(self.size)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))

    def close(self) -> None:
        """Leaves the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def _buckets(grads: Sequence[torch.Tensor], bucket_bytes: int):
    bucket, size = [], 0
    for g in grads:
        if bucket and (size + g.numel() * g.element_size() > bucket_bytes
                       or g.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        yield bucket


def init_world(world_size: int, rank: int, port: int, device: str = 'cuda',
               backend: Optional[str] = None, devices: Optional[Sequence] = None,
               addr: str = '127.0.0.1') -> World:
    """
    Joins the process group of `world_size` ranks as `rank`, meeting at
    ``tcp://addr:port``.

    The backend is NCCL when `device` is a CUDA device and gloo on the CPU,
    unless `backend` names one; rank r runs on ``devices[r]`` where
    `devices` is given (several gloo ranks may share one card), else on
    ``cuda:r`` (after ``torch.cuda.set_device``) or the CPU.
    """
    kind = torch.device(device).type
    backend = backend or ('nccl' if kind == 'cuda' else 'gloo')
    if devices is not None:
        dev = torch.device(devices[rank])
    else:
        dev = torch.device('cuda', rank) if kind == 'cuda' else torch.device('cpu')
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'rank {rank} asks for {dev} and no CUDA device is available')
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f'tcp://{addr}:{port}', world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    host = dist.new_group(backend='gloo') if backend != 'gloo' else None
    return World(rank=rank, size=world_size, device=dev, backend=backend, host_group=host)


def world_from_env(device: str = 'cuda', backend: Optional[str] = None,
                   devices: Optional[Sequence] = None) -> World:
    """:func:`init_world` from the ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` of the environment (what the
    launcher and ``torchrun`` set)."""
    return init_world(int(os.environ['WORLD_SIZE']), int(os.environ['RANK']),
                      int(os.environ['MASTER_PORT']), device=device, backend=backend,
                      devices=devices, addr=os.environ.get('MASTER_ADDR', '127.0.0.1'))


def pad_batch_to_multiple(batch: dict, n: int) -> dict:
    """
    Pads every array's leading (batch) dim to the next multiple of `n` by
    repeating samples from the start of the batch — the same strategy torch's
    DistributedSampler uses for ragged final batches, so data-parallel
    gradients stay well-defined at a tiny duplicate-sample bias on the last
    batch per epoch.
    """
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f'inconsistent leading batch dims: {sizes}')
    bs = sizes.pop()
    rem = (-bs) % n
    if rem == 0:
        return batch
    idx = np.arange(rem) % bs
    return {k: np.concatenate([np.asarray(v), np.asarray(v)[idx]], axis=0)
            for k, v in batch.items()}


def shard_batch(batch: dict, world: World) -> dict:
    """This rank's contiguous rows of every array in `batch`, whose batch
    size must be a multiple of the world size."""
    return {k: v[world.rows(len(v))] for k, v in batch.items()}


def replicate(world: World, tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of `tensors` (the parameters and buffers) on every
    rank, so that ranks which built a model from other random draws start
    equal."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def make_train_step(module, optimizer, world: Optional[World] = None,
                    frozen: Optional[Callable[[], Sequence[torch.Tensor]]] = None):
    """
    The data-parallel training step of a task module, the counterpart of
    the JAX package's ``make_train_step``: ``step(batch, rop_scale=1.0,
    **loss_kwargs) -> loss`` runs ``module.loss_fn`` on this rank's `batch`,
    its backward, the gradient all-reduce over `world` (none without one),
    and ``optimizer.step(rop_scale)``, on the module's device in float32
    (TF32 off). ``frozen()`` names the parameters the step must leave as
    they are (``freeze_backbone``): their gradients are zeroed after the
    all-reduce and their values put back after the step, since decoupled
    weight decay and the moments would move them.
    """
    from kraken_tpu_torch.inference.recognition import _precise_fp32
    params = module.parameters()

    def step(batch, rop_scale: float = 1.0, **loss_kwargs) -> torch.Tensor:
        for p in params:
            p.grad = None
        with _precise_fp32(torch.float32):
            loss = module.loss_fn(batch, **loss_kwargs)
            loss.backward()
            if world is not None:
                world.all_reduce_grads(params)
            hold = list(frozen()) if frozen is not None else []
            kept = [p.detach().clone() for p in hold]
            for p in hold:
                p.grad = torch.zeros_like(p)
            optimizer.step(rop_scale)
            if hold:
                with torch.no_grad():
                    for p, v in zip(hold, kept):
                        p.copy_(v)
        return loss.detach()
    return step


def recorded_steps(module, batch, world: Optional[World], steps: int, **loss_kwargs) -> dict:
    """`steps` steps of :func:`make_train_step` on `batch` (this rank's
    rows; `loss_kwargs` to the loss) with a new optimizer from the module's
    config, recorded for a parity check: the losses, the gradients the
    optimizer was handed at the first step (after the all-reduce) and the
    parameters after the last, on the host."""
    from kraken_tpu_torch.train import Optimizer
    optimizer = Optimizer(module.parameters(), module.config, 1)
    grads, losses = [], []
    step_fn = optimizer.step

    def spy(rop_scale=1.0):
        if not grads:
            grads.extend(None if p.grad is None else p.grad.detach().cpu().clone()
                         for p in module.parameters())
        return step_fn(rop_scale)
    optimizer.step = spy
    step = make_train_step(module, optimizer, world)
    for _ in range(steps):
        losses.append(float(step(batch, **loss_kwargs)))
    return {'losses': losses, 'grads': grads,
            'params': [p.detach().cpu().clone() for p in module.parameters()]}


def inference_devices(devices: int, device) -> list:
    """
    The devices an inference config's ``devices`` shards over: ``cuda:0``
    to ``cuda:N-1`` when `device` is a CUDA device (raising when fewer
    cards are visible, as the JAX package raises when its mesh lacks
    devices), else N times `device` (CPU shards).
    """
    n = int(devices or 1)
    if n < 1:
        raise ValueError(f'devices must be at least 1, not {devices}')
    dev = torch.device(device)
    if dev.type != 'cuda':
        return [dev] * n
    if n == 1:
        return [dev]
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise ValueError(f'devices={n} requested but only {visible} CUDA device(s) are visible')
    return [torch.device('cuda', i) for i in range(n)]


def replicas(net: torch.nn.Module, devices: Sequence[torch.device]) -> dict:
    """One copy of `net` on each distinct device of `devices` (the network
    itself where it already lies there), in its mode and dtype."""
    home = next(iter(net.parameters()), torch.empty(0)).device
    out = {}
    for dev in map(torch.device, devices):
        if dev not in out:
            out[dev] = net if dev == home else copy.deepcopy(net).to(dev)
    return out


def shard_rows(n: int, shards: int) -> list:
    """The contiguous rows of each of `shards` shards of a batch of `n` (a
    multiple of `shards`)."""
    if n % shards:
        raise ValueError(f'a batch of {n} does not split over {shards} shards')
    per = n // shards
    return [slice(i * per, (i + 1) * per) for i in range(shards)]


def make_infer_fn(net: torch.nn.Module, devices: Sequence, temperature: float = 1.0):
    """
    The recognition forward sharded over `devices` in one process, the
    counterpart of the JAX package's ``parallel/mesh.py:make_infer_fn``:
    one replica of `net` a device; ``fn(x, seq_lens) -> (labels, confs,
    olens)`` pads the (B, C, H, W) batch and its lengths (host arrays or
    CPU tensors) to a multiple of the device count with
    :func:`pad_batch_to_multiple`, forwards each contiguous shard and runs
    the tail kernel (``ops/tail.py``) on that shard's device, on its
    current stream (a shard of padding alone is not forwarded), and returns
    the per-frame labels, confidences and the output lengths as host arrays
    in batch order, without the padding.
    `devices` may repeat a device (several shards on one card, or CPU
    shards).
    """
    from kraken_tpu_torch.inference.recognition import _forward
    devices = [torch.device(d) for d in devices]
    nets = replicas(net, devices)
    dtype = next(iter(net.parameters()), torch.empty(0)).dtype

    def fn(x, seq_lens):
        x, seq_lens = np.asarray(x), np.asarray(seq_lens, np.int32)
        batch = pad_batch_to_multiple({'x': x, 'seq_lens': seq_lens}, len(devices))
        outs = []
        for dev, rows in zip(devices, shard_rows(len(batch['x']), len(devices))):
            if rows.start >= len(x):
                break   # a shard of padding alone is never read
            xs = torch.from_numpy(np.ascontiguousarray(batch['x'][rows])).to(dev, dtype)
            lens = torch.from_numpy(np.ascontiguousarray(batch['seq_lens'][rows])).to(dev)
            outs.append(_forward(nets[dev], dtype, xs, lens, temperature, probs=False))
        return tuple(np.concatenate([o[k].cpu().numpy() for o in outs])[:len(x)]
                     for k in (1, 2, 3))
    return fn
