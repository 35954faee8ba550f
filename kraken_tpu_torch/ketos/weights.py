"""
ketos convert (reference: kraken/ketos/weights.py), the counterpart of the
JAX package's: converts training checkpoints and weights files into one
plain weights file. A checkpoint's training state (``__training__.*``
tensors, ``training_meta``) is dropped.
"""
import click


@click.command('convert')
@click.pass_context
@click.option('-o', '--output', type=click.Path(), default='model.safetensors')
@click.option('--weights-format', '--format', 'fmt', default='safetensors',
              type=click.Choice(['safetensors', 'coreml']),
              help='Output weights format.')
@click.argument('checkpoints', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def convert(ctx, output, fmt, checkpoints):
    """
    Converts and combines one or more checkpoints/weights files into a
    deployable multi-model weights file.
    """
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.models import load_models, write_models

    if not checkpoints:
        raise click.UsageError('Checkpoint conversion requires at least one input checkpoint.')
    models = []
    for ckpt in checkpoints:
        models.extend(load_models(ckpt))
    write_models(models, output, format=fmt)
    message(f'Output file written to {output}')
