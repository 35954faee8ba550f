"""
ketos segtrain and segtest (reference: kraken/ketos/segmentation.py), the
counterparts of the JAX package's: ``segtrain`` trains a baseline
segmentation model on ``--device`` (in float32) and writes checkpoints and
the best model; ``segtest`` evaluates segmentation models on ``--device``.
Both read XML pages (``lxml``).
"""
from pathlib import Path

import click

from kraken_tpu_torch.ketos.util import _load_yaml_config, device_mesh, expand_manifests


def _print_class_stats(dataset):
    from kraken_tpu_torch.ketos import message
    message('Training line types:')
    for k, v in dataset.class_mapping['baselines'].items():
        message(f'  {k}\t{v}\t{dataset.class_stats["baselines"].get(k, 0)}')
    message('Training region types:')
    for k, v in dataset.class_mapping['regions'].items():
        message(f'  {k}\t{v}\t{dataset.class_stats["regions"].get(k, 0)}')


@click.command('segtrain')
@click.pass_context
@click.option('--config', callback=_load_yaml_config, is_eager=True,
              expose_value=False, type=click.Path(exists=True))
@click.option('-o', '--output', type=click.Path(), default='model')
@click.option('-s', '--spec', default=None, help='VGSL spec of the network')
@click.option('-i', '--load', type=click.Path(exists=True), default=None)
@click.option('--line-width', default=4, type=int,
              help='Width of the baseline strip in the rasterized target.')
@click.option('--dice-weight', default=0.5, type=float,
              help='Weight of the soft-Dice term in the loss (0 disables).')
@click.option('--bl-tol', default=25.0, type=float,
              help='Baseline-detection matching tolerance in pixels.')
@click.option('--weights-format', default='safetensors',
              type=click.Choice(['safetensors', 'coreml']))
@click.option('--log-dir', default=None, type=click.Path(file_okay=False))
@click.option('-B', '--batch-size', type=int, default=1)
@click.option('-F', '--freq', default=1.0, type=float)
@click.option('-q', '--quit', default='fixed', type=click.Choice(['early', 'fixed']))
@click.option('-N', '--epochs', default=-1, type=int)
@click.option('--min-epochs', default=0, type=int)
@click.option('--lag', default=10, type=int)
@click.option('--min-delta', default=0.0, type=float)
@click.option('--optimizer', default='Adam',
              type=click.Choice(['Adam', 'AdamW', 'SGD', 'RMSprop', 'Lamb']))
@click.option('-r', '--lrate', default=2e-4, type=float)
@click.option('-m', '--momentum', default=0.9, type=float)
@click.option('-w', '--weight-decay', default=1e-5, type=float)
@click.option('--warmup', default=0, type=int)
@click.option('--schedule', default='constant',
              type=click.Choice(['constant', '1cycle', 'exponential', 'cosine', 'step',
                                 'reduceonplateau']))
@click.option('-g', '--gamma', default=0.1, type=float,
              help='Decay factor for exponential/step/reduceonplateau schedules')
@click.option('-ss', '--step-size', default=10, type=int)
@click.option('--sched-patience', 'rop_patience', default=5, type=int)
@click.option('--cos-max', 'cos_t_max', default=10, type=int)
@click.option('--cos-min-lr', default=1e-6, type=float)
@click.option('--gradient-clip-val', default=1.0, type=float)
@click.option('--accumulate-grad-batches', default=1, type=int)
@click.option('--pad', 'padding', type=(int, int), default=(0, 0),
              help='Padding (left/right, top/bottom) around the page image')
@click.option('-p', '--partition', default=0.9, type=float)
@click.option('-t', '--training-data', '--training-files', 'training_files', multiple=True, callback=expand_manifests,
              type=click.Path(exists=True))
@click.option('-e', '--evaluation-data', '--evaluation-files', 'evaluation_files', multiple=True, callback=expand_manifests,
              type=click.Path(exists=True))
@click.option('-f', '--format-type', default='xml',
              type=click.Choice(['xml', 'alto', 'page']))
@click.option('--augment/--no-augment', default=False)
@click.option('--resize', default='fail', type=click.Choice(['fail', 'union', 'new',
                                                             'add', 'both']))
@click.option('-tl', '--topline', 'topline', flag_value=True,
              help='Baseline location: top')
@click.option('-cl', '--centerline', 'topline', flag_value=None)
@click.option('-bl', '--baseline', 'topline', flag_value=False, default=False)
@click.option('-vr', '--valid-regions', multiple=True,
              help='Whitelist of region types')
@click.option('-vb', '--valid-baselines', multiple=True,
              help='Whitelist of baseline types')
@click.option('-mr', '--merge-regions', multiple=True,
              help='Region merge mapping src:dest')
@click.option('-mb', '--merge-baselines', multiple=True,
              help='Baseline merge mapping src:dest')
@click.option('--remat/--no-remat', default=False,
              help='Rematerialize the forward on backward to save device memory.')
@click.option('--devices', type=int, default=1,
              help='Number of devices for data-parallel training: one process a device '
                   '(NCCL on cuda, gloo on cpu).')
@click.option('--resume', default=None, type=click.Path(exists=True),
              help='Resume training from a checkpoint.')
@click.option('--logger', 'loggers', default=None,
              type=click.Choice(['tensorboard', 'wandb']),
              help='Experiment logger backend.')
@click.option('--line-class-mapping', type=click.UNPROCESSED, hidden=True)
@click.option('--region-class-mapping', type=click.UNPROCESSED, hidden=True)
@click.argument('ground_truth', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def segtrain(ctx, output, spec, load, line_width, dice_weight, bl_tol,
             weights_format, log_dir, batch_size, freq, quit, epochs, min_epochs,
             lag, min_delta, optimizer, lrate, momentum, weight_decay, warmup,
             schedule, gamma, step_size, rop_patience, cos_t_max, cos_min_lr,
             gradient_clip_val, accumulate_grad_batches, padding,
             partition, training_files, evaluation_files, format_type,
             augment, resize, topline, valid_regions, valid_baselines,
             merge_regions, merge_baselines, remat, devices, resume, loggers,
             line_class_mapping, region_class_mapping, ground_truth):
    """
    Trains a baseline/region segmentation model.
    """
    from collections import defaultdict
    from kraken_tpu_torch.configs import (SegmentationTrainingConfig,
                                          SegmentationTrainingDataConfig, _Counter)
    from kraken_tpu_torch.kraken import _resolve_device
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.ketos.util import create_class_map
    from kraken_tpu_torch.train import (KrakenTrainer, SegmentationDataModule,
                                        SegmentationModel, convert_checkpoint)

    resize = {'add': 'union', 'both': 'new'}.get(resize, resize)
    training_data = list(ground_truth) + list(training_files or [])
    if not training_data:
        raise click.UsageError('No training data provided.')

    kwargs = dict(checkpoint_path=output, freq=freq, quit=quit, epochs=epochs,
                  min_epochs=min_epochs, lag=lag, min_delta=min_delta,
                  optimizer=optimizer, lrate=lrate, momentum=momentum,
                  weight_decay=weight_decay, warmup=warmup, schedule=schedule,
                  gamma=gamma, step_size=step_size, rop_patience=rop_patience,
                  cos_t_max=cos_t_max, cos_min_lr=cos_min_lr,
                  gradient_clip_val=gradient_clip_val,
                  accumulate_grad_batches=accumulate_grad_batches,
                  resize=resize, topline=topline, remat=remat, loggers=loggers,
                  dice_weight=dice_weight, bl_tol=bl_tol,
                  weights_format=weights_format,
                  device=_resolve_device(ctx.meta['device']), precision=ctx.meta['precision'])
    if devices != 1:
        kwargs['devices'] = devices
    if spec:
        kwargs['spec'] = spec
    config = SegmentationTrainingConfig(**kwargs)

    counter = _Counter(start=1)
    line_map = (create_class_map(line_class_mapping) if line_class_mapping
                else defaultdict(counter))
    region_map = (create_class_map(region_class_mapping) if region_class_mapping
                  else defaultdict(counter))
    merge_b = dict(m.split(':') for m in merge_baselines) if merge_baselines else {}
    merge_r = dict(m.split(':') for m in merge_regions) if merge_regions else {}

    class _FilteredMap(dict):
        def __init__(self, base, valid, merge):
            super().__init__()
            self._base = base
            self._valid = set(valid) if valid else None
            self._merge = merge

        def __missing__(self, key):
            key = self._merge.get(key, key)
            if self._valid is not None and key not in self._valid:
                raise KeyError(key)
            # bypass __contains__/__getitem__: they re-enter __missing__
            if not dict.__contains__(self, key):
                dict.__setitem__(self, key, self._base[key])
            return dict.__getitem__(self, key)

        def __contains__(self, key):
            try:
                self[key]
                return True
            except KeyError:
                return False

    data_config = SegmentationTrainingDataConfig(
        training_data=training_data,
        evaluation_data=list(evaluation_files) or None,
        partition=partition,
        format_type=format_type,
        augment=augment,
        topline=topline,
        line_width=line_width,
        padding=padding,
        line_class_mapping=_FilteredMap(line_map, valid_baselines, merge_b),
        region_class_mapping=_FilteredMap(region_map, valid_regions, merge_r),
        batch_size=batch_size,
        num_workers=ctx.meta['workers'])

    dm = SegmentationDataModule(data_config)
    module = (SegmentationModel.load_from_weights(config, load) if load
              else SegmentationModel(config))
    with device_mesh(devices, config.device) as mesh:
        trainer = KrakenTrainer(config, mesh=mesh, log_dir=log_dir)
        trainer.fit(module, dm, resume=resume)
    if not trainer.is_main:
        return
    train_ds = dm.train_set.dataset if hasattr(dm.train_set, 'dataset') else dm.train_set
    _print_class_stats(train_ds)
    best = trainer._ckpt_path('best')
    if best.exists():
        ext = '.mlmodel' if weights_format == 'coreml' else '.safetensors'
        out = Path(f'{output}_best{ext}')
        convert_checkpoint(best, out, format=weights_format)
        message(f'Best model written to {out}')


@click.command('segtest')
@click.pass_context
@click.option('-m', '--model', multiple=True, type=click.Path(exists=True))
@click.option('-e', '--test-data', '--evaluation-files', 'evaluation_files', multiple=True,
              callback=expand_manifests, type=click.Path(exists=True))
@click.option('-f', '--format-type', default='xml',
              type=click.Choice(['xml', 'alto', 'page']))
@click.option('--bl-tol', default=25.0, type=float,
              help='Baseline-detection matching tolerance in pixels.')
@click.option('--test-class-mapping-mode', default='full', show_default=True,
              type=click.Choice(['full', 'canonical', 'custom']),
              help='Which model class mapping to evaluate against: the full '
                   'mapping with merge aliases, the canonical mapping, or the '
                   'dataset-provided custom mapping.')
@click.option('--line-class-mapping', type=click.UNPROCESSED, hidden=True)
@click.option('--region-class-mapping', type=click.UNPROCESSED, hidden=True)
@click.argument('test_data', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def segtest(ctx, model, evaluation_files, format_type, bl_tol,
            test_class_mapping_mode, line_class_mapping, region_class_mapping,
            test_data):
    """
    Evaluates segmentation model(s) on a test set.
    """
    from kraken_tpu_torch.configs import (SegmentationTrainingConfig,
                                          SegmentationTrainingDataConfig)
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.train import SegmentationDataModule, SegmentationModel

    from kraken_tpu_torch.kraken import _resolve_device
    device = _resolve_device(ctx.meta['device'])
    if not model:
        raise click.UsageError('No model(s) given (-m).')
    files = list(test_data) + list(evaluation_files or [])
    if not files:
        raise click.UsageError('No test data provided.')
    for m in model:
        config = SegmentationTrainingConfig(device=device,
                                            precision=ctx.meta['precision'])
        module = SegmentationModel.load_from_weights(config, m)
        # mapping selection (reference: ketos/segmentation.py:471-477)
        if test_class_mapping_mode == 'custom' and (line_class_mapping
                                                    or region_class_mapping):
            from kraken_tpu_torch.ketos.util import create_class_map
            cm = {'baselines': create_class_map(line_class_mapping or []),
                  'regions': create_class_map(region_class_mapping or [])}
        elif (test_class_mapping_mode == 'full'
                and '_full_class_mapping' in module.net.user_metadata):
            cm = module.net.user_metadata['_full_class_mapping']
        else:
            cm = module.net.user_metadata.get('class_mapping', {})
        data_config = SegmentationTrainingDataConfig(
            test_data=files, format_type=format_type,
            line_class_mapping=cm.get('baselines', {}),
            region_class_mapping=cm.get('regions', {}),
            batch_size=1, num_workers=ctx.meta['workers'])
        dm = SegmentationDataModule(data_config)
        dm.setup('test')
        # the validation metrics over the test loader
        dm.val_set = dm.test_set
        module.setup('test', dm)
        results = module.validate(dm, bl_tol=bl_tol)
        message(f'=== {m} ===')
        for k, v in results.items():
            message(f'{k}: {v:.4f}')
