"""
ketos rotrain and roadd (reference: kraken/ketos/ro.py), the counterparts
of the JAX package's: ``rotrain`` trains a neural reading-order model on
XML pages (``lxml``) on ``--device``; ``roadd`` combines one with a
segmentation model.
"""
import logging

import click

from kraken_tpu_torch.ketos.util import _load_yaml_config, device_mesh, expand_manifests

logger = logging.getLogger('kraken')


@click.command('rotrain')
@click.pass_context
@click.option('--config', callback=_load_yaml_config, is_eager=True,
              expose_value=False, type=click.Path(exists=True))
@click.option('-o', '--output', type=click.Path(), default='model')
@click.option('-B', '--batch-size', type=int, default=6000)
@click.option('-F', '--freq', default=1.0, type=float)
@click.option('-q', '--quit', default='fixed', type=click.Choice(['early', 'fixed']))
@click.option('-N', '--epochs', default=-1, type=int)
@click.option('--lag', default=10, type=int)
@click.option('--min-epochs', default=0, type=int)
@click.option('--min-delta', default=0.0, type=float)
@click.option('--optimizer', default=None,
              type=click.Choice(['Adam', 'AdamW', 'SGD', 'RMSprop', 'Lamb']))
@click.option('-r', '--lrate', default=1e-3, type=float)
@click.option('-m', '--momentum', default=0.9, type=float)
@click.option('-w', '--weight-decay', default=0.01, type=float)
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
@click.option('-i', '--load', type=click.Path(exists=True), default=None,
              help='Warm start from weights or checkpoint')
@click.option('--resume', default=None, type=click.Path(exists=True))
@click.option('--weights-format', default='safetensors',
              type=click.Choice(['safetensors', 'coreml']))
@click.option('--logger', 'loggers', default=None,
              type=click.Choice(['tensorboard', 'wandb']))
@click.option('--log-dir', default=None, type=click.Path(file_okay=False))
@click.option('-p', '--partition', default=0.9, type=float)
@click.option('-t', '--training-data', '--training-files', 'training_files', multiple=True, callback=expand_manifests,
              type=click.Path(exists=True))
@click.option('-e', '--evaluation-data', '--evaluation-files', 'evaluation_files', multiple=True, callback=expand_manifests,
              type=click.Path(exists=True))
@click.option('-f', '--format-type', default='xml',
              type=click.Choice(['xml', 'alto', 'page']))
@click.option('--level', default='baselines', type=click.Choice(['baselines', 'regions']),
              help='Compute reading order on line or region level.')
@click.option('--reading-order', default=None,
              help='Name of the reading order to train on.')
@click.option('--class-mapping', type=click.UNPROCESSED, hidden=True)
@click.option('--class-mapping-from-ckpt', type=click.Path(exists=True),
              default=None,
              help='Extract the class mapping from a segmentation checkpoint; '
                   '--level selects the baseline or region mapping.')
@click.option('--devices', type=int, default=1,
              help='Number of devices for data-parallel training: one process a device '
                   '(NCCL on cuda, gloo on cpu).')
@click.argument('ground_truth', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def rotrain(ctx, output, batch_size, freq, quit, epochs, min_epochs, lag,
            min_delta, optimizer, lrate, momentum, weight_decay,
            gradient_clip_val, accumulate_grad_batches, warmup, schedule,
            gamma, step_size, rop_patience, cos_t_max, cos_min_lr, load,
            resume, weights_format, loggers, log_dir, partition,
            training_files, evaluation_files, format_type, level, reading_order,
            class_mapping, class_mapping_from_ckpt, devices, ground_truth):
    """
    Trains a reading order determination model.
    """
    from kraken_tpu_torch.configs import ReadingOrderTrainingConfig, TrainingDataConfig
    from kraken_tpu_torch.dataset.utils import _get_type
    from kraken_tpu_torch.kraken import _resolve_device
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.train import KrakenTrainer, RODataModule, ROModel
    from kraken_tpu_torch.xml import XMLPage

    training_data = list(ground_truth) + list(training_files or [])
    if not training_data:
        raise click.UsageError('No training data provided.')
    kwargs = dict(checkpoint_path=output, freq=freq, quit=quit, epochs=epochs,
                  min_epochs=min_epochs, lag=lag, min_delta=min_delta,
                  momentum=momentum, weight_decay=weight_decay,
                  gradient_clip_val=gradient_clip_val,
                  accumulate_grad_batches=accumulate_grad_batches,
                  warmup=warmup, schedule=schedule, gamma=gamma,
                  step_size=step_size, rop_patience=rop_patience,
                  cos_t_max=cos_t_max, cos_min_lr=cos_min_lr,
                  weights_format=weights_format, loggers=loggers,
                  lrate=lrate, level=level, reading_order=reading_order,
                  device=_resolve_device(ctx.meta['device']), precision=ctx.meta['precision'])
    if devices != 1:
        kwargs['devices'] = devices
    if optimizer:
        kwargs['optimizer'] = optimizer
    config = ReadingOrderTrainingConfig(**kwargs)
    # explicit class mapping beats checkpoint extraction beats observation
    if class_mapping and class_mapping_from_ckpt:
        raise click.UsageError('--class-mapping and --class-mapping-from-ckpt '
                               'are mutually exclusive.')
    if class_mapping:
        from kraken_tpu_torch.ketos.util import create_class_map
        class_mapping = dict(create_class_map(class_mapping))
    elif class_mapping_from_ckpt:
        from kraken_tpu_torch.train import load_checkpoint
        net, _ = load_checkpoint(class_mapping_from_ckpt)
        seg_map = net.user_metadata.get('class_mapping', {})
        section = 'baselines' if level == 'baselines' else 'regions'
        class_mapping = {'default': 0}
        for i, key in enumerate(seg_map.get(section, {}), start=1):
            class_mapping[key] = i
    else:
        class_mapping = None
    # otherwise build the class mapping from the observed tags
    _observe = class_mapping is None
    if _observe:
        class_mapping = {'default': 0}
    for f in training_data:
        try:
            doc = XMLPage(f, filetype=format_type)
            elements = (doc.lines.values() if level == 'baselines'
                        else [r for regs in doc.regions.values() for r in regs])
            for el in elements:
                tag = _get_type(el.tags)
                if _observe and tag not in class_mapping:
                    class_mapping[tag] = len(class_mapping)
        except ValueError as e:
            logger.warning(f'Invalid file {f}: {e}')
    data_config = TrainingDataConfig(training_data=training_data,
                                     evaluation_data=list(evaluation_files) or None,
                                     partition=partition,
                                     batch_size=batch_size,
                                     num_workers=ctx.meta['workers'])
    data_config.format_type = format_type
    data_config.reading_order = reading_order
    dm = RODataModule(data_config, class_mapping=class_mapping, level=level)
    module = (ROModel.load_from_weights(config, load, level=level) if load
              else ROModel(config, level=level))
    with device_mesh(devices, config.device) as mesh:
        trainer = KrakenTrainer(config, mesh=mesh, log_dir=log_dir)
        trainer.fit(module, dm, resume=resume)
    if not trainer.is_main:
        return
    message(f'Training complete. Best epoch: {trainer.best_epoch} '
            f'(metric {trainer.best_metric:.4f})')




@click.command('roadd')
@click.pass_context
@click.option('-o', '--output', type=click.Path(), default='combined.safetensors',
              help='Output file for the combined model.')
@click.option('-r', '--ro-model', type=click.Path(exists=True), required=True,
              help='Reading order model (checkpoint or weights).')
@click.option('-i', '--seg-model', type=click.Path(exists=True), required=True,
              help='Segmentation model to combine with.')
def roadd(ctx, output, ro_model, seg_model):
    """
    Combines a reading order model with a segmentation model into one file.
    """
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.models import load_models, write_models

    models = load_models(seg_model)
    ro_models = [m for m in load_models(ro_model)
                 if 'reading_order' in getattr(m, 'model_type', [])]
    if not ro_models:
        raise click.UsageError(f'No reading order model found in {ro_model}')
    write_models(models + ro_models, output)
    message(f'Combined model written to {output}')
