"""Non-dataset data helpers: arbitrary-mesh sampling + prediction saving
(counterpart of nn/data/utils.py:96-160).

The port's copy of garment_pattern_estimation_tpu/data/utils.py:1-63.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core import NNSewingPattern, InvalidPatternDefError
from ..preprocess import mesh as mesh_ops
from ..losses.stitches import tags_to_stitches_np


def sample_points_from_meshes(mesh_paths, data_config, seed=None):
    """Sample standardized point clouds from arbitrary triangle meshes."""
    stats = data_config.get('standardize')
    clouds = []
    for i, mesh_path in enumerate(mesh_paths):
        verts, faces = mesh_ops.read_triangle_mesh(str(mesh_path))
        cloud = mesh_ops.sample_mesh_points(
            data_config['mesh_samples'], verts, faces,
            seed=None if seed is None else seed + i)
        if stats:
            cloud = (cloud - np.asarray(stats['f_shift'])) \
                / np.asarray(stats['f_scale'])
        clouds.append(cloud.astype(np.float32))
    return clouds


def save_garments_prediction(predictions, save_to, data_config=None, datanames=None,
                             stitches_from_stitch_tags=False, panel_classifier=None):
    """Save arbitrary (non-dataset) pattern predictions to disk."""
    out_root = Path(save_to)
    n_patterns = np.asarray(predictions['outlines']).shape[0]
    names = datanames if datanames is not None \
        else [f'pred_{i}' for i in range(n_patterns)]

    for idx, name in enumerate(names):
        prediction = {key: np.asarray(batch[idx])
                      for key, batch in predictions.items()}

        if data_config is not None and 'standardize' in data_config:
            stats = data_config['standardize']
            for key, shift in stats['gt_shift'].items():
                if key == 'stitch_tags' and not data_config.get('explicit_stitch_tags', False):
                    continue
                prediction[key] = prediction[key] * np.asarray(stats['gt_scale'][key]) \
                    + np.asarray(shift)

        stitches = tags_to_stitches_np(
            prediction['stitch_tags'], prediction['free_edges_mask']) \
            if stitches_from_stitch_tags else None

        pattern = NNSewingPattern(view_ids=False, panel_classifier=panel_classifier)
        pattern.name = name
        try:
            pattern.pattern_from_tensors(
                prediction['outlines'], prediction['rotations'],
                prediction['translations'], stitches=stitches, padded=True)
            pattern.serialize(out_root, to_subfolder=True)
        except (RuntimeError, InvalidPatternDefError, TypeError) as err:
            print(err)
            print(f'Saving predictions::skipping pattern {name}')
