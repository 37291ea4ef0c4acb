"""Sewing-pattern visualization: panels as 2D outlines with curvature.

The port's copy of garment_pattern_estimation_tpu/core/render.py: a
matplotlib renderer that emits PNG and SVG. matplotlib is imported inside
the functions, so importing this module needs no matplotlib.
"""
from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')  # headless
    import matplotlib.pyplot as plt
    return plt


def panel_outline_path(panel):
    """Matplotlib Path for one panel: edges with relative curvature (cx, cy)
    become quadratic Beziers with control point A + cx*(B-A) + cy*perp(B-A)."""
    from matplotlib.path import Path as MplPath

    vertices = np.asarray(panel['vertices'], dtype=float)
    path_verts = []
    path_codes = []
    first = True
    for edge in panel['edges']:
        start_id, end_id = edge['endpoints']
        start, end = vertices[start_id], vertices[end_id]
        if first:
            path_verts.append(start)
            path_codes.append(MplPath.MOVETO)
            first = False
        if 'curvature' in edge and edge['curvature'] is not None and any(edge['curvature']):
            cx, cy = edge['curvature']
            direction = end - start
            perp = np.array([-direction[1], direction[0]])
            control = start + cx * direction + cy * perp
            path_verts.extend([control, end])
            path_codes.extend([MplPath.CURVE3, MplPath.CURVE3])
        else:
            path_verts.append(end)
            path_codes.append(MplPath.LINETO)
    if not path_verts:
        return None
    return MplPath(path_verts, path_codes)


def render_pattern(pattern, out_file, view_ids=False, panels_per_row=6, spacing=10.0):
    """Draw all panels of `pattern` laid out in a grid and save to `out_file`
    (format inferred from extension: .png or .svg)."""
    from matplotlib.patches import PathPatch
    from matplotlib.path import Path as MplPath

    plt = _pyplot()
    panel_names = [n for n in pattern.panel_order() if n is not None]
    if not panel_names:
        # render an empty canvas rather than failing
        fig, ax = plt.subplots(figsize=(2, 2))
        ax.axis('off')
        fig.savefig(out_file, bbox_inches='tight')
        plt.close(fig)
        return str(out_file)

    fig, ax = plt.subplots(figsize=(min(4 * min(len(panel_names), panels_per_row), 24),
                                    4 * (1 + (len(panel_names) - 1) // panels_per_row)))
    colors = plt.cm.tab20(np.linspace(0, 1, max(len(panel_names), 2)))

    offset_x, offset_y = 0.0, 0.0
    row_height = 0.0
    for i, name in enumerate(panel_names):
        panel = pattern.pattern['panels'][name]
        verts = np.asarray(panel['vertices'], dtype=float)
        if len(verts) == 0:
            continue
        low = verts.min(axis=0)
        size = verts.max(axis=0) - low

        if i > 0 and i % panels_per_row == 0:
            offset_x = 0.0
            offset_y -= row_height + spacing
            row_height = 0.0
        # panels hang DOWNWARD from the row top: a panel taller than the
        # previous row's height can then never overlap the row above
        shift = np.array([offset_x - low[0], offset_y - low[1] - size[1]])

        path = panel_outline_path(panel)
        if path is not None:
            shifted = MplPath(np.asarray(path.vertices) + shift, path.codes)
            ax.add_patch(PathPatch(shifted, facecolor=colors[i % len(colors)],
                                   edgecolor='black', alpha=0.6, lw=1.2))
        label = name
        ax.text(offset_x + size[0] / 2, offset_y + 1.5, label,
                ha='center', fontsize=8)
        if view_ids:
            for vid, v in enumerate(verts):
                ax.text(*(v + shift), str(vid), fontsize=6, color='darkred')

        offset_x += size[0] + spacing
        row_height = max(row_height, size[1])

    ax.set_aspect('equal')
    ax.relim()
    ax.autoscale_view()
    ax.axis('off')
    ax.set_title(pattern.name, fontsize=10)
    fig.savefig(out_file, bbox_inches='tight')
    plt.close(fig)
    return str(out_file)
