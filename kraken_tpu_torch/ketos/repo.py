"""
ketos publish subcommand (reference: kraken/ketos/repo.py), the counterpart
of the JAX package's ``ketos/repo.py``: uploads a model with its metadata
card to the model repository. The model is loaded on the host to check it
before the upload; no device is used.
"""
import logging

import click

logger = logging.getLogger('kraken')


@click.command('publish')
@click.pass_context
@click.option('-i', '--metadata', type=click.Path(exists=True),
              help='JSON file with model metadata (model card).')
@click.option('-a', '--access-token', required=True,
              help='Repository access token.')
@click.option('-d', '--doi', default=None,
              help='DOI of an existing record to update.')
@click.option('-p', '--private/--public', default=False,
              help='Upload as a private (invisible) record.')
@click.argument('model', nargs=1, type=click.Path(exists=True, dir_okay=False))
def publish(ctx, metadata, access_token, doi, private, model):
    """
    Publishes a model on the model repository.
    """
    import json
    from kraken_tpu_torch import repo
    from kraken_tpu_torch.exceptions import KrakenRepoException
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.models import load_models

    # validate the model loads before uploading
    models = load_models(model)
    card = {}
    if metadata:
        with open(metadata) as fp:
            card = json.load(fp)
    card.setdefault('software_name', 'kraken')
    card.setdefault('keywords', ['kraken_pytorch'])
    types = sorted({t for m in models for t in getattr(m, 'model_type', [])})
    card.setdefault('model_type', types)
    try:
        if doi:
            new_doi = repo.update_model(doi, card, model, access_token,
                                        private=private)
        else:
            new_doi = repo.publish_model(card, model, access_token,
                                         private=private)
    except KrakenRepoException as e:
        message(str(e), fg='red')
        ctx.exit(1)
    message(f'model published under DOI: {new_doi}')
