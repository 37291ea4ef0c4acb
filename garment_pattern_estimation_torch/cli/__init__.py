"""Command-line entry points of the port, on the card unless `--device cpu`
is given: `python -m garment_pattern_estimation_torch.cli.<name> ...` with
<name> one of `train` (-c <config.yaml> --system <system.json>),
`on_test_set`, `predict_per_example`, `noise_levels` and `export_serving`."""

__all__ = ['train', 'on_test_set', 'predict_per_example', 'noise_levels', 'export_serving']
