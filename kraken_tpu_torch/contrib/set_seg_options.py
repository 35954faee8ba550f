#!/usr/bin/env python
"""
Edits segmentation model metadata (bounding regions, topline flag, input
padding) and writes the model file back (reference:
kraken/contrib/set_seg_options.py), the counterpart of the JAX package's
contrib script. Runs no model:

    python -m kraken_tpu_torch.contrib.set_seg_options -br text --topline seg.safetensors
"""
import click


@click.command()
@click.option('--bounding-region', '-br', multiple=True,
              help='Sets region types used as boundaries for polygonization.')
@click.option('--topline/--baseline', 'topline', default=None)
@click.option('--pad', type=(int, int), default=None,
              help='Input padding (left/right, top/bottom).')
@click.argument('model', nargs=1, type=click.Path(exists=True))
def cli(bounding_region, topline, pad, model):
    from kraken_tpu_torch.models import load_models, write_models

    models = load_models(model)
    net = [m for m in models if 'segmentation' in m.model_type][0]
    if bounding_region:
        net.user_metadata['bounding_regions'] = list(bounding_region)
    if topline is not None:
        net.user_metadata['topline'] = topline
    if pad is not None:
        net.user_metadata['hyper_params'] = {**net.user_metadata.get('hyper_params', {}),
                                             'padding': list(pad)}
    write_models(models, model)
    click.echo('Metadata updated:')
    for key in ('bounding_regions', 'topline', 'hyper_params'):
        click.echo(f'  {key}: {net.user_metadata.get(key)}')


if __name__ == '__main__':
    cli()
