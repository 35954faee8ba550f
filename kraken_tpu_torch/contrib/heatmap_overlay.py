#!/usr/bin/env python
"""
Overlays the class heatmaps of a segmentation model on the input images
(reference: kraken/contrib/heatmap_overlay.py), the counterpart of the JAX
package's contrib script. Runs on the card unless ``--device cpu``:

    python -m kraken_tpu_torch.contrib.heatmap_overlay -i seg.safetensors page.png

writes ``page.png.heat.png``: each pixel coloured by its strongest class,
scaled by that class's probability, half transparent over the page.
"""
import click


@click.command()
@click.option('-i', '--model', type=click.Path(exists=True), required=True)
@click.option('--suffix', default='.heat.png')
@click.option('-d', '--device', default='cuda', show_default=True,
              help="Torch device to run on ('cuda', 'cuda:N' or 'cpu').")
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(model, suffix, device, files):
    import numpy as np
    from PIL import Image
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.inference.recognition import resolve_device
    from kraken_tpu_torch.inference.segmentation import (_compute_segmentation_maps,
                                                         prepare_segmentation)
    from kraken_tpu_torch.models import load_models

    try:
        resolve_device(device)
    except RuntimeError as e:
        raise click.UsageError(str(e))
    net = [m for m in load_models(model) if 'segmentation' in m.model_type][0]
    prepare_segmentation(net, SegmentationInferenceConfig(device=device))
    for fname in files:
        im = Image.open(fname)
        heat = _compute_segmentation_maps(net, [im])[0]['heatmap']
        # colorize the class argmax over the heatmap stack
        classes = heat.argmax(axis=0)
        strength = heat.max(axis=0)
        rng = np.random.RandomState(42)
        palette = rng.randint(0, 255, (heat.shape[0], 3), np.uint8)
        rgb = palette[classes] * strength[..., None]
        overlay = Image.fromarray(rgb.astype(np.uint8)).convert('RGBA')
        overlay.putalpha(128)
        base = im.convert('RGBA').resize(overlay.size)
        out = Image.alpha_composite(base, overlay)
        out_name = fname + suffix
        out.convert('RGB').save(out_name)
        click.echo(f'Wrote {out_name}')


if __name__ == '__main__':
    cli()
