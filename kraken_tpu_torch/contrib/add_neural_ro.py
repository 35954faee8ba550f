#!/usr/bin/env python
"""
Attaches a trained neural reading-order model to a segmentation model file
(reference: kraken/contrib/add_neural_ro.py), the counterpart of the JAX
package's contrib script. Runs no model:

    python -m kraken_tpu_torch.contrib.add_neural_ro -r ro.safetensors -o out.safetensors seg.safetensors
"""
import click


@click.command()
@click.option('-r', '--ro-model', type=click.Path(exists=True), required=True)
@click.option('-o', '--output', type=click.Path(), default=None)
@click.argument('seg_model', nargs=1, type=click.Path(exists=True))
def cli(ro_model, output, seg_model):
    from kraken_tpu_torch.models import load_models, write_models

    models = load_models(seg_model)
    ros = [m for m in load_models(ro_model)
           if 'reading_order' in getattr(m, 'model_type', [])]
    if not ros:
        raise click.UsageError(f'No reading order model in {ro_model}')
    write_models(models + ros, output or seg_model)
    click.echo(f'Wrote combined model to {output or seg_model}')


if __name__ == '__main__':
    cli()
