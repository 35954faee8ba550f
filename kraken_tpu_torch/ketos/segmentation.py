"""
ketos segtest (reference: kraken/ketos/segmentation.py), the counterpart of
the JAX package's: evaluates segmentation models on XML pages (needs
``lxml``) on ``--device``. ``segtrain`` waits for ROADMAP.md queue 1 item
9b.
"""
import click

from kraken_tpu_torch.ketos.util import expand_manifests


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
