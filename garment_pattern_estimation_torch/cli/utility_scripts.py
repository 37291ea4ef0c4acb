"""Small data utilities, on the host (the port's copy of
garment_pattern_estimation_tpu/cli/utility_scripts.py, the counterpart of
nn/utility_scripts/):

    # count datapoints passing the design-parameter filter per data folder
    python -m garment_pattern_estimation_torch.cli.utility_scripts param_filter \
        --data_root ./data --filter ./param_filter.json

    # sanity-check surface sampling on one mesh (igl_sampling_test equivalent)
    python -m garment_pattern_estimation_torch.cli.utility_scripts sampling_check \
        --obj path/to/mesh.obj

    # package a dataset folder into a portable archive, and back
    python -m garment_pattern_estimation_torch.cli.utility_scripts pack \
        --data_root ./data --folder tee_synth_300 --out ./artifacts
    python -m garment_pattern_estimation_torch.cli.utility_scripts unpack \
        --archive ./artifacts/tee_synth_300.tar.gz --data_root ./data
"""
from __future__ import annotations

import argparse
import json
import tarfile
from pathlib import Path

import numpy as np


def param_filter_count(data_root, filter_file, folders=None):
    """{folder: (passed, total)}: the datapoints of each folder whose design
    parameters lie inside the filter's ranges for the folder's template."""
    from ..core import NNSewingPattern
    with open(filter_file) as f:
        param_filters = json.load(f)
    data_root = Path(data_root)
    folders = folders or [p.name for p in data_root.iterdir() if p.is_dir()]
    results = {}
    for folder in folders:
        total = passed = 0
        for datapoint in (data_root / folder).iterdir():
            spec = datapoint / 'specification.json'
            if not spec.exists():
                continue
            total += 1
            pattern = NNSewingPattern(spec)
            template = folder.rsplit('_', 1)[0]
            bounds_map = param_filters.get(template, {})
            ok = all(bounds[0] <= pattern.parameters.get(p, {}).get('value', bounds[0])
                     <= bounds[1] for p, bounds in bounds_map.items())
            passed += ok
        results[folder] = (passed, total)
        print(f'{folder}: {passed} of {total} pass the parameter filter')
    return results


def sampling_check(obj_path, num_points=1000, seed=0):
    """Sample `num_points` points of a mesh with the host sampler and print
    their bounding box and largest distance to a vertex. Returns the points."""
    from ..preprocess import mesh as mesh_ops
    verts, faces = mesh_ops.read_triangle_mesh(obj_path)
    points = mesh_ops.sample_mesh_points(num_points, verts, faces, seed=seed)
    _, sq_dist = mesh_ops.snap_points(points, verts)
    print(f'mesh: {len(verts)} verts / {len(faces)} faces')
    print(f'sampled {len(points)} points; bbox {points.min(0)} .. {points.max(0)}')
    print(f'max point->vertex distance: {np.sqrt(sq_dist).max():.4f}')
    return points


def pack_dataset(data_root, folder, out_dir):
    """`<out_dir>/<folder>.tar.gz` of one data folder."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    archive = out_dir / f'{folder}.tar.gz'
    with tarfile.open(archive, 'w:gz') as tar:
        tar.add(Path(data_root) / folder, arcname=folder)
    print(f'Packed {archive}')
    return archive


def unpack_dataset(archive, data_root):
    """Extract a packed data folder under `data_root` (tarfile's 'data'
    filter: no absolute paths, links or devices out of it)."""
    with tarfile.open(archive, 'r:gz') as tar:
        tar.extractall(Path(data_root), filter='data')
    print(f'Unpacked {archive} into {data_root}')


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('param_filter')
    p.add_argument('--data_root', required=True)
    p.add_argument('--filter', required=True)
    p.add_argument('--folders', nargs='*', default=None)

    p = sub.add_parser('sampling_check')
    p.add_argument('--obj', required=True)
    p.add_argument('--num_points', type=int, default=1000)

    p = sub.add_parser('pack')
    p.add_argument('--data_root', required=True)
    p.add_argument('--folder', required=True)
    p.add_argument('--out', required=True)

    p = sub.add_parser('unpack')
    p.add_argument('--archive', required=True)
    p.add_argument('--data_root', required=True)

    args = parser.parse_args(argv)
    if args.command == 'param_filter':
        return param_filter_count(args.data_root, args.filter, args.folders)
    if args.command == 'sampling_check':
        return sampling_check(args.obj, args.num_points)
    if args.command == 'pack':
        return pack_dataset(args.data_root, args.folder, args.out)
    if args.command == 'unpack':
        return unpack_dataset(args.archive, args.data_root)


if __name__ == '__main__':
    main()
