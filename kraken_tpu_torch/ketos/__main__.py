from kraken_tpu_torch.ketos import cli

if __name__ == '__main__':
    cli()
