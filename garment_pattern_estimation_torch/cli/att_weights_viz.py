"""Visualize saved per-point attention weights on the input point cloud, on
the host:

    python -m garment_pattern_estimation_torch.cli.att_weights_viz \
        --prediction_dir output/nn_test_pred_*/test/tee/<sample>

The port's copy of garment_pattern_estimation_tpu/cli/att_weights_viz.py
(the counterpart of nn/evaluation_scripts/maya_att_weights.py): the saved
`*_point_cloud.txt` and `*_att_weights.txt` of a prediction folder, written
by `save_prediction_batch`, render to a matplotlib 3D scatter PNG, each
point colored by its argmax panel. matplotlib is imported only to draw, so
importing this module needs none; drawing without it raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def render_att_weights(points, att_weights, out_file, max_panels_to_show=None):
    """Color every point by its argmax panel; alpha by assignment confidence."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    assignment = att_weights.argmax(axis=-1)
    confidence = att_weights.max(axis=-1)
    panels = np.unique(assignment)
    if max_panels_to_show:
        panels = panels[:max_panels_to_show]

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection='3d')
    colors = plt.cm.tab20(np.linspace(0, 1, max(att_weights.shape[-1], 2)))
    for panel in panels:
        sel = assignment == panel
        ax.scatter(points[sel, 0], points[sel, 1], points[sel, 2],
                   s=6, color=colors[panel % len(colors)],
                   alpha=np.clip(confidence[sel].mean(), 0.3, 1.0),
                   label=f'panel {panel} ({sel.sum()} pts)')
    ax.set_box_aspect([1, 1, 1])
    ax.legend(loc='upper left', fontsize=7)
    fig.savefig(out_file, dpi=120, bbox_inches='tight')
    plt.close(fig)
    return out_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--prediction_dir', '-d', type=str, required=True,
                        help='datapoint prediction folder with '
                             '*_point_cloud.txt and *_att_weights.txt')
    parser.add_argument('--out', type=str, default=None)
    args = parser.parse_args(argv)

    pred_dir = Path(args.prediction_dir)
    cloud_files = sorted(pred_dir.glob('*_point_cloud.txt'))
    weight_files = sorted(pred_dir.glob('*_att_weights.txt'))
    if not cloud_files or not weight_files:
        raise FileNotFoundError(
            f'att_weights_viz::need *_point_cloud.txt and *_att_weights.txt in {pred_dir}')
    points = np.loadtxt(cloud_files[0])
    weights = np.loadtxt(weight_files[0])
    out = Path(args.out) if args.out else pred_dir / (cloud_files[0].stem + '_att_viz.png')
    render_att_weights(points, weights, out)
    print(f'Saved {out}')
    return out


if __name__ == '__main__':
    main()
