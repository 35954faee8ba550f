"""
ketos roadd (reference: kraken/ketos/ro.py), the counterpart of the JAX
package's. ``rotrain`` waits for ROADMAP.md queue 1 item 9b.
"""
import click


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
