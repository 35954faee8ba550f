#!/usr/bin/env python
"""
Computes per-file character error rates of a recognition model over ground
truth pages (reference: kraken/contrib/test_per_file.py), the counterpart
of the JAX package's contrib script. Reads ALTO/PageXML (needs ``lxml``)
and runs on the card unless ``--device cpu``:

    python -m kraken_tpu_torch.contrib.test_per_file -m model.safetensors page.xml
"""
import click


@click.command()
@click.option('-m', '--model', type=click.Path(exists=True), required=True)
@click.option('-f', '--format-type', type=click.Choice(['xml', 'alto', 'page']),
              default='xml')
@click.option('--pad', type=int, default=16)
@click.option('-d', '--device', default='cuda', show_default=True,
              help="Torch device to run on ('cuda', 'cuda:N' or 'cpu').")
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(model, format_type, pad, device, files):
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.inference.recognition import resolve_device
    from kraken_tpu_torch.lib.util import open_image
    from kraken_tpu_torch.tasks import RecognitionTaskModel
    from kraken_tpu_torch.train.metrics import CharErrorRate
    from kraken_tpu_torch.xml import XMLPage

    try:
        resolve_device(device)
    except RuntimeError as e:
        raise click.UsageError(str(e))
    task = RecognitionTaskModel.load_model(model)
    config = RecognitionInferenceConfig(padding=pad, device=device)
    total = CharErrorRate()
    for fname in files:
        doc = XMLPage(fname, filetype=format_type)
        seg = doc.to_container()
        im = open_image(doc.imagename)
        cer = CharErrorRate()
        for record, line in zip(task.predict(im, seg, config), seg.lines):
            if line.text:
                cer.update(record.prediction, line.text)
                total.update(record.prediction, line.text)
        click.echo(f'{fname}\tCER {cer.compute() * 100:.2f}%')
    click.echo(f'TOTAL\tCER {total.compute() * 100:.2f}%')


if __name__ == '__main__':
    cli()
