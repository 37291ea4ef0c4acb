"""Command-line entry points of the port: `python -m
garment_pattern_estimation_torch.cli.<name> ...` with <name> one of `train`
(-c <config.yaml> --system <system.json>), `on_test_set`,
`predict_per_example`, `noise_levels` and `export_serving`, on the card
unless `--device cpu` is given, and the host tools `att_weights_viz` and
`utility_scripts`."""

__all__ = ['train', 'on_test_set', 'predict_per_example', 'noise_levels', 'export_serving',
           'att_weights_viz', 'utility_scripts']
