"""
kraken_tpu_torch.train.trainer
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The training loop, the counterpart of the JAX package's
``train/trainer.py`` (itself the reference's Lightning KrakenTrainer,
kraken/train/utils.py): epochs of optimizer steps, validation at a
configurable frequency (a fraction validates inside the epoch), top-K
checkpoints by the validation metric with ``best`` kept, early stopping
with ``lag``/``min_delta``, reduce-on-plateau as a multiplier on the
update, ``freeze_backbone``, an abort checkpoint on an exception,
``resume``, a tensorboard or wandb logger (each only where it imports) and
a ``torch.profiler`` trace of the first epoch in ``profile_dir``.

A step runs on the module's device inside ``_precise_fp32`` (no TF32: the
forward, ``loss.backward()`` and the optimizer step), so on the card the
LSTM and GroupNorm layers run their forward and backward kernels. Dropout
draws from one ``torch.Generator`` on that device, seeded from numpy's
global state (which ``ketos --seed`` seeds).

With a ``mesh`` (a ``parallel.World``, the JAX trainer's mesh) the fit is
one rank of a data-parallel run: rank 0's parameters and buffers are
broadcast at the start, the loader is sharded (one shuffle order, each rank
loading its rows of every global batch), the gradients are averaged over
the ranks after the backward (``parallel.make_train_step``), before the
frozen-backbone zeroing and the optimizer step. Rank 0 alone validates,
writes checkpoints and logs; it broadcasts its stop decision and
reduce-on-plateau scale after every validation, so that every rank stops or
reduces the rate at the same step. The epoch loss is averaged over the
ranks when it is read. Each rank's generator is seeded with rank 0's seed
plus its rank.

Task modules provide:
    net                          the model (VGSLModel or ROMLP)
    setup(stage, datamodule)     builds ``loss_fn`` and places the net
    parameters()                 the trainable parameters, in a fixed order
    loss_fn(batch) -> tensor     the mini-batch's scalar loss
    validate(datamodule) -> dict with 'val_metric' (higher = better)
    checkpoint_extras() -> dict  metadata kept in checkpoints
    checkpoint_tensors() -> dict arrays kept beside the model's in
                                 checkpoints (pretraining's parameters)
    load_checkpoint_tensors(path) restores them on ``resume``
"""
import contextlib
import logging
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from kraken_tpu_torch.exceptions import KrakenStopTrainingException
from kraken_tpu_torch.parallel import make_train_step, replicate
from kraken_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from kraken_tpu_torch.train.optim import Optimizer

logger = logging.getLogger(__name__)

__all__ = ['KrakenTrainer', 'TrainingModule']


class _ExperimentLogger:
    """Scalar logging behind ``--logger tensorboard|wandb`` (reference:
    kraken/train/utils.py:124-141), each backend only where it imports."""

    def __init__(self, backend: Optional[str], log_dir: str, config) -> None:
        self._tb = None
        self._wandb = None
        if backend == 'tensorboard':
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir)
            except ImportError:
                logger.warning('tensorboard not available; scalar logging disabled.')
        elif backend == 'wandb':
            try:
                import wandb
                self._wandb = wandb.init(dir=log_dir, config=vars(config))
            except ImportError:
                logger.warning('wandb not available; scalar logging disabled.')

    def log_scalars(self, scalars: dict, step: int) -> None:
        numeric = {k: float(v) for k, v in scalars.items()
                   if isinstance(v, (int, float, np.floating))}
        if self._tb is not None:
            for k, v in numeric.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(numeric, step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class TrainingModule:
    """
    What the task modules share for :class:`KrakenTrainer`: the torch
    module of their model (``net.net`` of a VGSLModel, the ROMLP itself),
    its parameters in a fixed order, its device, train and eval modes, and
    ``remat`` (``torch.utils.checkpoint`` without reentry, replaying the
    dropout generator's state, as ``jax.checkpoint`` replays its key).
    """

    generator: Optional[torch.Generator] = None
    # the data-parallel world the module's loss is computed in (the
    # trainer's mesh), or None
    world = None

    def _torch_net(self) -> torch.nn.Module:
        return self.net.net if hasattr(self.net, 'net') else self.net

    def parameters(self) -> list[torch.Tensor]:
        return list(self._torch_net().parameters())

    @property
    def device(self) -> torch.device:
        return next(self._torch_net().parameters()).device

    def net_train(self) -> None:
        self._torch_net().train().requires_grad_(True)

    def net_eval(self) -> None:
        self._torch_net().eval().requires_grad_(False)

    def _place_for_training(self) -> None:
        """The model on the config's device in float32 (training runs in
        float32 whatever the precision), in training mode."""
        from kraken_tpu_torch.inference.recognition import resolve_device
        self._device = resolve_device(self.config.device)
        self._dtype = torch.float32
        self._torch_net().to(device=self._device, dtype=torch.float32)
        self.net_train()

    def checkpoint_tensors(self) -> dict:
        return {}

    def load_checkpoint_tensors(self, path) -> None:
        pass

    def _run(self, fn, *args):
        """fn(*args), through ``torch.utils.checkpoint`` when the config
        asks for ``remat``."""
        if not getattr(self.config, 'remat', False):
            return fn(*args)
        from torch.utils.checkpoint import checkpoint
        generator = self.generator
        state = generator.get_state() if generator is not None else None

        def contexts():
            @contextlib.contextmanager
            def replay():
                after = generator.get_state()
                generator.set_state(state)
                try:
                    yield
                finally:
                    generator.set_state(after)
            return contextlib.nullcontext(), (replay() if generator is not None
                                              else contextlib.nullcontext())
        return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


def _dropout_layers(module: torch.nn.Module):
    from kraken_tpu_torch.nn.layers import Dropout, TransformerEncoder
    return [m for m in module.modules() if isinstance(m, (Dropout, TransformerEncoder))]


class KrakenTrainer:
    """Drives the training of a task module according to a TrainingConfig."""

    def __init__(self, config, mesh=None, progress: bool = True, fast_dev_run: bool = False,
                 log_dir: Optional[str] = None):
        self.config = config
        self.mesh = mesh
        self.progress = progress
        self.fast_dev_run = fast_dev_run
        self.log_dir = log_dir
        self.current_epoch = 0
        self.global_step = 0
        self.best_metric = -math.inf
        self.best_epoch = -1
        self.metrics_history: list[dict] = []
        self._ckpt_ledger: list[tuple[float, Path]] = []
        self.optimizer: Optional[Optimizer] = None

    @property
    def is_main(self) -> bool:
        """Whether this process validates, checkpoints and logs: rank 0 of
        the mesh, or the only process."""
        return self.mesh is None or self.mesh.is_main

    # ------------------------------------------------------------------ fit
    def fit(self, module, datamodule, resume: Optional[str] = None) -> None:
        config = self.config
        world = self.mesh
        module.trainer = self
        module.world = world
        datamodule.setup('fit')
        module.setup('fit', datamodule)
        if world is not None and module.device != world.device:
            raise ValueError(f'rank {world.rank} runs on {world.device}, its module on '
                             f'{module.device}')

        train_loader = datamodule.train_dataloader()
        if world is not None:
            train_loader.shard(world)
        if len(train_loader) == 0:
            # drop_last with a batch size above the training set size would
            # train zero steps an epoch
            raise ValueError(
                f'Training dataloader yields no batches: batch size '
                f'({getattr(datamodule.config, "batch_size", "?")}) exceeds '
                f'the training set size with drop_last. Lower the batch size.')
        steps_per_epoch = max(1, len(train_loader))
        params = module.parameters()
        optimizer = Optimizer(params, config, steps_per_epoch)
        self.optimizer = optimizer

        if resume is not None:
            # weights, optimizer state and epoch/step counters (reference:
            # ketos/recognition.py --resume)
            ckpt_model, meta = load_checkpoint(resume, optimizer)
            with torch.no_grad():
                module.net.load_state_dict(ckpt_model.state_dict(), prefix='nn.')
            module.load_checkpoint_tensors(resume)
            config.completed_epochs = int(meta.get('epoch', -1)) + 1
            self.global_step = int(meta.get('global_step', 0))
            logger.info(f'Resumed from {resume} at epoch {config.completed_epochs}, '
                        f'step {self.global_step}.')
        if world is not None:
            replicate(world, params + list(module._torch_net().buffers()))

        exp_logger = _ExperimentLogger(config.loggers if self.is_main else None,
                                       self.log_dir or str(Path(config.checkpoint_path).parent / 'runs'),
                                       config)
        device = module.device
        seed = int(np.random.randint(0, 2**31 - 1))
        if world is not None:
            seed = world.broadcast_object(seed) + world.rank
        generator = torch.Generator(device=device).manual_seed(seed)
        module.generator = generator
        for layer in _dropout_layers(module._torch_net()):
            layer.generator = generator

        # all but the output layer frozen for the first N steps (reference:
        # KrakenFreezeBackbone, kraken/train/utils.py:197-225): the JAX
        # trainer zeroes their gradients and their updates; here the
        # gradients are zeroed and the parameters put back after the step
        # (decoupled weight decay and the moments would move them)
        freeze_steps = int(config.freeze_backbone or 0) if hasattr(config, 'freeze_backbone') else 0
        frozen: list[torch.Tensor] = []
        if freeze_steps and hasattr(module.net, 'net'):
            head = getattr(module.net.net, module.net.net.names[-1])
            head_params = {id(p) for p in head.parameters()}
            frozen = [p for p in params if id(p) not in head_params]

        train_step = make_train_step(
            module, optimizer, world,
            frozen=lambda: frozen if self.global_step < freeze_steps else ())

        def mean_loss(total: torch.Tensor, n: int) -> float:
            """The epoch's loss so far, over every rank's shards."""
            return (float(total) if world is None else world.mean(total)) / max(n, 1)

        epochs = config.epochs if config.epochs and config.epochs > 0 else \
            (1 if self.fast_dev_run else 10**6)
        lag_counter = 0
        rop_counter = 0
        rop_scale = 1.0
        # a fractional freq validates several times an epoch (reference:
        # Lightning val_check_interval, kraken/ketos/recognition.py:192-195)
        val_interval = (max(1, int(steps_per_epoch * config.freq))
                        if 0 < config.freq < 1 else None)

        def run_validation(tag, avg_loss):
            """Validation, checkpoints, early-stop and ROP bookkeeping on
            rank 0, whose decisions every rank takes; True when training
            should stop."""
            nonlocal rop_scale
            stop = validate(tag, avg_loss) if self.is_main else None
            if world is not None:
                stop, rop_scale = world.broadcast_object((stop, rop_scale))
            return stop

        def validate(tag, avg_loss):
            nonlocal lag_counter, rop_counter, rop_scale
            epoch = self.current_epoch
            module.net_eval()
            val_metrics = module.validate(datamodule)
            module.net_train()
            val_metrics['loss'] = avg_loss
            val_metrics['epoch'] = epoch
            self.metrics_history.append(val_metrics)
            if hasattr(module.net, 'user_metadata'):
                module.net.user_metadata.setdefault('metrics', []).append(
                    (epoch, {k: float(v) if isinstance(v, (int, float, np.floating)) else v
                             for k, v in val_metrics.items()}))
            metric = val_metrics.get('val_metric', -avg_loss)
            exp_logger.log_scalars(val_metrics, epoch)
            logger.info(f'validation @{tag}: ' + ' '.join(
                f'{k}={v:.4f}' for k, v in val_metrics.items()
                if isinstance(v, (int, float, np.floating))))
            self._checkpoint(module, tag, metric)
            if metric > self.best_metric + config.min_delta:
                self.best_metric = metric
                self.best_epoch = epoch
                lag_counter = 0
                rop_counter = 0
            else:
                lag_counter += 1
                rop_counter += 1
            if (config.quit == 'early' and epoch >= config.min_epochs
                    and lag_counter >= config.lag):
                logger.info(f'Early stopping after {config.lag} validations without improvement.')
                return True
            if config.schedule == 'reduceonplateau' and rop_counter >= config.rop_patience:
                # only the update multiplier changes: the optimizer's
                # moments carry over
                rop_scale *= config.rop_factor
                rop_counter = 0
                logger.info(f'Reducing learning rate by {config.rop_factor} (scale now {rop_scale}).')
            return False

        profiler = None
        stop = False
        try:
            for epoch in range(config.completed_epochs, epochs):
                self.current_epoch = epoch
                epoch_loss = torch.zeros((), device=device)
                n_batches = 0
                if config.profile_dir and epoch == config.completed_epochs:
                    profiler = _start_profiler(config.profile_dir)
                for batch in train_loader:
                    epoch_loss += train_step(batch, rop_scale)
                    self.global_step += 1
                    n_batches += 1
                    if (val_interval and not self.fast_dev_run
                            and self.global_step % val_interval == 0):
                        stop = run_validation(f'{epoch}_s{self.global_step}',
                                              mean_loss(epoch_loss, n_batches))
                        if stop:
                            break
                    if self.fast_dev_run:
                        break
                if profiler is not None:
                    profiler.__exit__(None, None, None)
                    profiler = None
                    logger.info(f'Wrote profiler trace for epoch {epoch} to {config.profile_dir}')
                avg_loss = mean_loss(epoch_loss, n_batches)
                logger.info(f'epoch {epoch}: loss {avg_loss:.4f}')
                exp_logger.log_scalars({'train_loss': avg_loss,
                                        'lr': optimizer.lr(rop_scale)}, epoch)
                if stop:
                    break
                # integer freq validates at epoch ends; a fractional one
                # validated inside the epoch and also closes an epoch whose
                # steps the interval does not divide
                run_val = ((config.freq >= 1 and (epoch + 1) % int(config.freq) == 0)
                           or (val_interval is not None
                               and (self.fast_dev_run or self.global_step % val_interval != 0)))
                if run_val:
                    stop = run_validation(str(epoch), avg_loss)
                    if stop:
                        break
                if self.fast_dev_run:
                    break
        except KeyboardInterrupt:
            if self.is_main:
                logger.warning('Training interrupted. Writing abort checkpoint.')
                self._write(module, 'checkpoint_abort')
            raise
        except KrakenStopTrainingException:
            logger.info('Training stopped by callback.')
        except Exception:
            if self.is_main:
                self._write(module, 'checkpoint_abort')
            raise
        finally:
            if profiler is not None:
                profiler.__exit__(None, None, None)
            exp_logger.close()
            module.net_eval()

    # ----------------------------------------------------------- checkpoint
    def _ckpt_path(self, name: str) -> Path:
        base = Path(self.config.checkpoint_path)
        if base.suffix:
            base = base.with_suffix('')
        base.parent.mkdir(parents=True, exist_ok=True)
        return base.parent / f'{base.name}_{name}.safetensors'

    def _write(self, module, name: str) -> Path:
        path = self._ckpt_path(name)
        extras = module.checkpoint_extras()
        save_checkpoint(module.net, self.optimizer, path, epoch=self.current_epoch,
                        global_step=self.global_step,
                        hyper_params={'config_class': type(self.config).__name__,
                                      **vars(self.config)},
                        extras=extras, tensors=module.checkpoint_tensors())
        logger.info(f'Wrote checkpoint {path}')
        return path

    def _checkpoint(self, module, epoch, metric: float) -> None:
        # only the top-K epoch checkpoints by validation metric (reference:
        # ModelCheckpoint(save_top_k=10), kraken/ketos/recognition.py:199-205);
        # 'best' always stays
        path = self._write(module, f'{epoch}')
        self._ckpt_ledger.append((metric, path))
        top_k = int(self.config.save_top_k or 0)
        if top_k > 0 and len(self._ckpt_ledger) > top_k:
            self._ckpt_ledger.sort(key=lambda t: t[0], reverse=True)
            for _, stale in self._ckpt_ledger[top_k:]:
                stale.unlink(missing_ok=True)
                logger.info(f'Pruned checkpoint {stale}')
            self._ckpt_ledger = self._ckpt_ledger[:top_k]
        if metric > self.best_metric:
            self._write(module, 'best')

    # ----------------------------------------------------------------- test
    def test(self, module, datamodule):
        datamodule.setup('test')
        module.setup('test', datamodule)
        return module.test(datamodule)


def _start_profiler(profile_dir: str):
    """A ``torch.profiler`` trace (CPU and, where there is one, the card)
    written to `profile_dir` when it ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.__enter__()
    return prof
