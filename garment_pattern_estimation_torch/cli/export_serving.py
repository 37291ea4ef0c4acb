"""Export a trained shape model as a self-contained serving artifact, on the
card unless `--device cpu` is given:

    python -m garment_pattern_estimation_torch.cli.export_serving \
        -c configs/att.yaml -o ./serving/att_b64 --batch 64 [--bf16]

The port's counterpart of garment_pattern_estimation_tpu/cli/export_serving.py
(its `--platforms` is `--device` here): loads the experiment's checkpoint,
fuses feature standardization + forward + prediction un-standardization into
one program and saves it with `torch.export` (experiment/serving.py). The
directory is the whole deployment: `experiment.load_serving_artifact` needs
no model code, config or checkpoint. `--bf16` exports the bf16
mixed-precision serving mode (outputs f32). The artifact runs on the device
type it was exported on.
"""
from __future__ import annotations

import argparse

from .common import load_yaml, make_experiment, system_properties
from ..device import resolve_device


def get_values_from_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-c', '--config', type=str, default='./configs/att.yaml')
    parser.add_argument('-o', '--output', type=str, required=True,
                        help='artifact directory to create')
    parser.add_argument('-b', '--batch', type=int, default=64,
                        help='serving batch size baked into the program')
    parser.add_argument('-n', '--points', type=int, default=None,
                        help='points per cloud (default: dataset mesh_samples)')
    parser.add_argument('--bf16', action='store_true',
                        help='export the bf16 mixed-precision serving mode')
    parser.add_argument('--device', type=str, default=None,
                        help="device to export for (default: 'cuda')")
    parser.add_argument('--alias', type=str, default='best',
                        help='checkpoint alias to export')
    parser.add_argument('--system', type=str, default='./system.json')
    args = parser.parse_args(argv)
    return load_yaml(args.config), args


def main(argv=None):
    config, args = get_values_from_args(argv)
    system_info = system_properties(args.system)
    experiment = make_experiment(config, system_info)
    if not experiment.is_finished():
        print('Warning::Exporting an unfinished experiment')

    from ..experiment.serving import export_serving_artifact

    _, stored_batch, data_config = experiment.data_info()
    model, _ = experiment.load_model(
        data_config, alias=args.alias, device=resolve_device(args.device),
        nn_overrides={'compute_dtype': 'bfloat16'} if args.bf16 else None)

    num_points = args.points or data_config.get('mesh_samples', 2000)
    manifest = export_serving_artifact(
        model, data_config, args.output,
        batch_size=args.batch or stored_batch, num_points=num_points,
        extra_manifest={'experiment': experiment.full_name(),
                        'checkpoint_alias': args.alias,
                        'compute_dtype': 'bfloat16' if args.bf16 else 'float32'})
    print(f'export_serving::ok {args.output} '
          f'(platforms={manifest["platforms"]}, '
          f'{manifest["blob_bytes"] / 1e6:.1f} MB, '
          f'input {manifest["input"]["shape"]})')
    return manifest


if __name__ == '__main__':
    main()
