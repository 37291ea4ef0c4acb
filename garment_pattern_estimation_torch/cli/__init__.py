"""Command-line entry points of the port: `python -m
garment_pattern_estimation_torch.cli.train -c <config.yaml> --system
<system.json>`."""
