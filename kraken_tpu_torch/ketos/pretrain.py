"""
ketos pretrain (reference: kraken/ketos/pretrain.py), the counterpart of
the JAX package's: unsupervised contrastive pretraining of a recognition
backbone on ``--device`` (in float32), writing checkpoints that warm-start
``ketos train -i``. Lines need no transcription; a dataset with text is
encoded with a one-glyph codec, one without is left unencoded.
"""
import click

from kraken_tpu_torch.ketos.util import _load_yaml_config, device_mesh, expand_manifests


@click.command('pretrain')
@click.pass_context
@click.option('--config', callback=_load_yaml_config, is_eager=True,
              expose_value=False, type=click.Path(exists=True))
@click.option('-o', '--output', type=click.Path(), default='model')
@click.option('-s', '--spec', default=None, help='VGSL spec of the network')
@click.option('-i', '--load', type=click.Path(exists=True), default=None)
@click.option('-B', '--batch-size', type=int, default=4)
@click.option('-F', '--freq', default=1.0, type=float)
@click.option('-q', '--quit', default='fixed', type=click.Choice(['early', 'fixed']))
@click.option('-N', '--epochs', default=-1, type=int)
@click.option('--min-epochs', default=0, type=int)
@click.option('--lag', default=10, type=int)
@click.option('--min-delta', default=0.0, type=float)
@click.option('--optimizer', default=None,
              type=click.Choice(['Adam', 'AdamW', 'SGD', 'RMSprop', 'Lamb']))
@click.option('-r', '--lrate', default=1e-4, type=float)
@click.option('-m', '--momentum', default=0.9, type=float)
@click.option('-w', '--weight-decay', default=0.0, type=float)
@click.option('--gradient-clip-val', default=1.0, type=float)
@click.option('--accumulate-grad-batches', default=1, type=int)
@click.option('--warmup', default=0, type=int)
@click.option('--schedule', default='constant',
              type=click.Choice(['constant', '1cycle', 'exponential', 'cosine',
                                 'step', 'reduceonplateau']))
@click.option('-g', '--gamma', default=0.1, type=float)
@click.option('-ss', '--step-size', default=10, type=int)
@click.option('--sched-patience', 'rop_patience', default=5, type=int)
@click.option('--cos-max', 'cos_t_max', default=10, type=int)
@click.option('--cos-min-lr', default=1e-6, type=float)
@click.option('--pad', default=16, type=int,
              help='Left/right padding around lines')
@click.option('--linetype', default=None, type=click.Choice(['baselines', 'bbox']))
@click.option('--legacy-polygons', is_flag=True, default=False)
@click.option('--weights-format', default='safetensors',
              type=click.Choice(['safetensors', 'coreml']))
@click.option('--logger', 'loggers', default=None,
              type=click.Choice(['tensorboard', 'wandb']))
@click.option('--log-dir', default=None, type=click.Path(file_okay=False))
@click.option('-p', '--partition', default=0.9, type=float)
@click.option('-mp', '--mask-probability', 'mask_prob', default=0.5, type=float)
@click.option('-mw', '--mask-width', default=4, type=int)
@click.option('-nn', '--num-negatives', default=100, type=int)
@click.option('-lt', '--logit-temp', default=0.1, type=float)
@click.option('-t', '--training-data', '--training-files', 'training_files', multiple=True,
              callback=expand_manifests, type=click.Path(exists=True))
@click.option('-e', '--evaluation-data', '--evaluation-files', 'evaluation_files', multiple=True,
              callback=expand_manifests, type=click.Path(exists=True))
@click.option('-f', '--format-type', default='binary',
              type=click.Choice(['path', 'xml', 'alto', 'page', 'binary']))
@click.option('--augment/--no-augment', default=False)
@click.option('--resume', default=None, type=click.Path(exists=True),
              help='Resume training from a checkpoint.')
@click.option('--devices', type=int, default=1,
              help='Number of devices for data-parallel training: one process a device '
                   '(NCCL on cuda, gloo on cpu).')
@click.argument('ground_truth', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def pretrain(ctx, output, spec, load, batch_size, freq, quit, epochs, min_epochs,
             lag, min_delta, optimizer, lrate, momentum, weight_decay,
             gradient_clip_val, accumulate_grad_batches, warmup, schedule, gamma,
             step_size, rop_patience, cos_t_max, cos_min_lr, pad, linetype,
             legacy_polygons, weights_format, loggers, log_dir, partition,
             mask_prob, mask_width, num_negatives, logit_temp,
             training_files, evaluation_files, format_type, augment, resume,
             devices, ground_truth):
    """
    Unsupervised pretraining of recognition models.
    """
    from kraken_tpu_torch.configs import PretrainingConfig, RecognitionTrainingDataConfig
    from kraken_tpu_torch.kraken import _resolve_device
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.pretrain import PretrainDataModule, RecognitionPretrainModel
    from kraken_tpu_torch.train import KrakenTrainer

    training_data = list(ground_truth) + list(training_files or [])
    if not training_data:
        raise click.UsageError('No training data provided.')
    kwargs = dict(checkpoint_path=output, freq=freq, quit=quit, epochs=epochs,
                  min_epochs=min_epochs, lag=lag, min_delta=min_delta,
                  momentum=momentum, weight_decay=weight_decay,
                  gradient_clip_val=gradient_clip_val,
                  accumulate_grad_batches=accumulate_grad_batches,
                  lrate=lrate, warmup=warmup, schedule=schedule, gamma=gamma,
                  step_size=step_size, rop_patience=rop_patience,
                  cos_t_max=cos_t_max, cos_min_lr=cos_min_lr,
                  weights_format=weights_format, loggers=loggers,
                  mask_prob=mask_prob, mask_width=mask_width,
                  num_negatives=num_negatives, logit_temp=logit_temp,
                  device=_resolve_device(ctx.meta['device']), precision=ctx.meta['precision'])
    if devices != 1:
        kwargs['devices'] = devices
    if spec:
        kwargs['spec'] = spec
    if optimizer:
        kwargs['optimizer'] = optimizer
    config = PretrainingConfig(**kwargs)
    data_config = RecognitionTrainingDataConfig(
        training_data=training_data,
        evaluation_data=list(evaluation_files) or None,
        partition=partition,
        format_type=format_type,
        augment=augment,
        pad=pad,
        linetype=linetype,
        batch_size=batch_size,
        num_workers=ctx.meta['workers'])
    data_config.legacy_polygons = legacy_polygons

    dm = PretrainDataModule(data_config)
    module = (RecognitionPretrainModel.load_from_weights(config, load) if load
              else RecognitionPretrainModel(config))
    with device_mesh(devices, config.device) as mesh:
        trainer = KrakenTrainer(config, mesh=mesh, log_dir=log_dir)
        trainer.fit(module, dm, resume=resume)
    if not trainer.is_main:
        return
    message(f'Pretraining complete. Checkpoints under {output}_*.safetensors')
