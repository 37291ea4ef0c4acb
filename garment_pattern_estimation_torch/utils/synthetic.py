"""Synthetic garment dataset generator.

The real sewing-pattern dataset (maria-korosteleva.gitlab.io dataset of
~22k garments) is not bundled with either repo, so tests, benchmarks, and
end-to-end smoke training need a stand-in that exercises every code path:
spec JSON files in the reference's on-disk layout
(`<root>/<data_folder>/<datapoint>/specification.json` + `*_sim.obj` +
`*sim_segmentation.txt` + per-folder `dataset_properties.json` — see
nn/data/datasets.py:43-58, 433-472, 770-905), panels with curvature,
3D placement, and stitches.

Geometry is parameterized per 'template' so panel/edge counts vary across
garment types like in the real data.

The port's copy of garment_pattern_estimation_tpu/utils/synthetic.py:1-457:
the same seed writes byte-equal files.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..core.pattern_codec import NNSewingPattern
from ..core import rotations as rot_tools


# ---------------- panel construction helpers ----------------

def _quad_panel(width, height, curve_top=0.0):
    """Axis-aligned quad panel centered at x=0 with bottom at y=0.
    Vertices counter-clockwise; optionally bows the top edge."""
    w2 = width / 2.0
    vertices = [[-w2, 0.0], [w2, 0.0], [w2, height], [-w2, height]]
    edges = [
        {'endpoints': [0, 1]},
        {'endpoints': [1, 2]},
        {'endpoints': [2, 3]},
        {'endpoints': [3, 0]},
    ]
    if abs(curve_top) > 1e-6:
        edges[2] = {'endpoints': [2, 3], 'curvature': [0.5, curve_top]}
    return vertices, edges


def _trapezoid_panel(top_width, bottom_width, height, n_side_splits=0):
    """Symmetric trapezoid with optional extra vertices along the sides
    (to vary per-panel edge counts across templates)."""
    tw2, bw2 = top_width / 2.0, bottom_width / 2.0
    left_pts = [  # bottom-left -> top-left
        [-(bw2 + (tw2 - bw2) * t), height * t]
        for t in np.linspace(0, 1, n_side_splits + 2)
    ]
    right_pts = [[-(x), y] for x, y in left_pts]  # mirrored

    vertices = []
    vertices.extend([right_pts[0]])              # bottom-right
    vertices.extend(right_pts[1:])               # up the right side
    vertices.extend(reversed(left_pts))          # top-left down to bottom-left
    # build closed loop of edges
    edges = [{'endpoints': [i, (i + 1) % len(vertices)]} for i in range(len(vertices))]
    return [list(map(float, v)) for v in vertices], edges


TEMPLATES = {
    # name -> list of (panel_name, builder kwargs, rotation deg, translation
    # fn(rng)[, class_role]) — class_role (default: panel_name) is the panel
    # class the panel maps to in panel_classes_for_templates. The UNSEEN
    # templates reuse ONLY class roles that the seen templates define, so a
    # model trained on seen types can represent them (the reference's unseen
    # types map onto the shared class set the same way —
    # reference models/att/att.yaml:27-34, nn/data/panel_classes.py)
    'tee': {
        'panels': [
            ('front', dict(kind='quad', width=44, height=55, curve_top=0.12), [0, 0, 0], [0, 20, 12]),
            ('back', dict(kind='quad', width=46, height=56, curve_top=0.08), [0, 180, 0], [0, 20, -12]),
            ('lsleeve', dict(kind='trapezoid', top_width=18, bottom_width=24, height=22), [0, 0, 90], [-30, 55, 0]),
            ('rsleeve', dict(kind='trapezoid', top_width=18, bottom_width=24, height=22), [0, 0, -90], [30, 55, 0]),
        ],
        'stitches': [
            (('front', 1), ('back', 3)),   # right side seam
            (('front', 3), ('back', 1)),   # left side seam
            (('lsleeve', 0), ('front', 2)),
            (('rsleeve', 2), ('back', 2)),
        ],
    },
    'skirt': {
        'panels': [
            ('sfront', dict(kind='trapezoid', top_width=36, bottom_width=60, height=50, n_side_splits=1), [0, 0, 0], [0, -35, 10]),
            ('sback', dict(kind='trapezoid', top_width=38, bottom_width=62, height=50, n_side_splits=1), [0, 180, 0], [0, -35, -10]),
        ],
        'stitches': [
            (('sfront', 1), ('sback', 4)),
            (('sfront', 4), ('sback', 1)),
        ],
    },
    'jumpsuit': {
        # the bodice panels share the front/back CLASS ROLES with tee/tank
        # (reference panel classes group panels across templates the same
        # way — nn/data_configs/panel_classes_condenced.json): cross-template
        # role sharing is what makes unseen-type recombination learnable
        'panels': [
            ('jfront', dict(kind='quad', width=40, height=50, curve_top=0.1), [0, 0, 0], [0, 22, 11], 'front'),
            ('jback', dict(kind='quad', width=42, height=52, curve_top=0.06), [0, 180, 0], [0, 22, -11], 'back'),
            ('lpant', dict(kind='trapezoid', top_width=26, bottom_width=20, height=60), [0, 0, 0], [-12, -42, 9]),
            ('rpant', dict(kind='trapezoid', top_width=26, bottom_width=20, height=60), [0, 180, 0], [12, -42, -9]),
            ('hood', dict(kind='quad', width=26, height=30, curve_top=0.25), [30, 0, 0], [0, 62, -4]),
        ],
        'stitches': [
            (('jfront', 1), ('jback', 3)),
            (('jfront', 3), ('jback', 1)),
            # waist seams: the pants' TOP edge (edge 1 of a 4-vertex
            # trapezoid) onto the bodice bottom. Using a pant SIDE edge here
            # (as an earlier revision did) creates a label conflict: the
            # positive pair's geometry is then nearly identical to sampled
            # negative side-edge pairs, and the pair classifier learns the
            # majority (negative) label — jumpsuit recall capped at 0.77
            (('lpant', 1), ('jfront', 0)),
            (('rpant', 1), ('jback', 0)),
            (('hood', 0), ('jback', 2)),
        ],
    },
    # -------- additional SEEN templates (round-5 zero-shot support) -------
    # These widen the seen distribution so the UNSEEN templates below become
    # recombinations of seen factors (role x shape x height), mirroring how
    # the reference's 7 unseen types recombine its 12 seen types
    # (models/att/att.yaml:13-34). Key coverage:
    #   tank        -> 2-panel quad garments in the front/back roles
    #   pants/shorts-> standalone pant-role garments at two lengths
    #   maxi_skirt  -> tall (h~85) garments
    #   aline_skirt -> 4-edge trapezoid panels in a 2-panel garment
    # so unseen 'dress' = tall 4-edge trapezoid front/back (novel role x
    # shape x height combination) and 'vest' = strongly-curved quad
    # front/back — both interpolations, neither memorized.
    'tank': {
        'panels': [
            ('front', dict(kind='quad', width=36, height=50, curve_top=0.05), [0, 0, 0], [0, 18, 12]),
            ('back', dict(kind='quad', width=38, height=51, curve_top=0.03), [0, 180, 0], [0, 18, -12]),
        ],
        'stitches': [
            (('front', 1), ('back', 3)),
            (('front', 3), ('back', 1)),
        ],
    },
    'pants': {
        'panels': [
            ('lpant', dict(kind='trapezoid', top_width=28, bottom_width=22, height=65), [0, 0, 0], [-13, -45, 9]),
            ('rpant', dict(kind='trapezoid', top_width=28, bottom_width=22, height=65), [0, 180, 0], [13, -45, -9]),
        ],
        'stitches': [
            (('lpant', 0), ('rpant', 2)),
            (('lpant', 2), ('rpant', 0)),
        ],
    },
    'shorts': {
        'panels': [
            ('lpant', dict(kind='trapezoid', top_width=30, bottom_width=26, height=28), [0, 0, 0], [-13, -25, 9]),
            ('rpant', dict(kind='trapezoid', top_width=30, bottom_width=26, height=28), [0, 180, 0], [13, -25, -9]),
        ],
        'stitches': [
            (('lpant', 0), ('rpant', 2)),
            (('lpant', 2), ('rpant', 0)),
        ],
    },
    'maxi_skirt': {
        'panels': [
            ('sfront', dict(kind='trapezoid', top_width=34, bottom_width=70, height=85, n_side_splits=1), [0, 0, 0], [0, -55, 10]),
            ('sback', dict(kind='trapezoid', top_width=36, bottom_width=72, height=86, n_side_splits=1), [0, 180, 0], [0, -55, -10]),
        ],
        'stitches': [
            (('sfront', 1), ('sback', 4)),
            (('sfront', 4), ('sback', 1)),
        ],
    },
    'aline_skirt': {
        'panels': [
            ('sfront', dict(kind='trapezoid', top_width=36, bottom_width=72, height=45), [0, 0, 0], [0, -30, 10]),
            ('sback', dict(kind='trapezoid', top_width=38, bottom_width=74, height=46), [0, 180, 0], [0, -30, -10]),
        ],
        'stitches': [
            (('sfront', 0), ('sback', 2)),
            (('sfront', 2), ('sback', 0)),
        ],
    },
    # -------- UNSEEN templates (generalization eval, never trained on) ----
    # tall flared trapezoid bodice — the unseen silhouette is new, the class
    # roles (front/back) are not
    'dress': {
        'unseen': True,
        'panels': [
            ('dfront', dict(kind='trapezoid', top_width=40, bottom_width=68, height=95), [0, 0, 0], [0, -20, 11], 'front'),
            ('dback', dict(kind='trapezoid', top_width=42, bottom_width=70, height=96), [0, 180, 0], [0, -20, -11], 'back'),
        ],
        'stitches': [
            (('dfront', 0), ('dback', 2)),   # right side seam
            (('dfront', 2), ('dback', 0)),   # left side seam
        ],
    },
    # sleeveless short bodice — tee-like classes without the sleeve panels
    'vest': {
        'unseen': True,
        'panels': [
            ('vfront', dict(kind='quad', width=40, height=45, curve_top=0.18), [0, 0, 0], [0, 25, 11], 'front'),
            ('vback', dict(kind='quad', width=42, height=46, curve_top=0.10), [0, 180, 0], [0, 25, -11], 'back'),
        ],
        'stitches': [
            (('vfront', 1), ('vback', 3)),
            (('vfront', 3), ('vback', 1)),
        ],
    },
}

#: templates excluded from the default (training) folder set — used by the
#: `--unseen` generalization demo (reference: on_test_set.py:55-126)
UNSEEN_TEMPLATES = tuple(n for n, t in TEMPLATES.items() if t.get('unseen'))


def make_pattern(template_name, rng, panel_classifier=None):
    """Build a randomized NNSewingPattern instance of the given template."""
    tpl = TEMPLATES[template_name]
    pattern = NNSewingPattern(panel_classifier=panel_classifier, template_name=template_name)
    scale_jitter = 1.0 + 0.2 * (rng.random() - 0.5)

    panel_order = []
    for panel_name, kwargs, rotation, translation, *_ in tpl['panels']:
        kwargs = dict(kwargs)
        kind = kwargs.pop('kind')
        for key in ('width', 'height', 'top_width', 'bottom_width'):
            if key in kwargs:
                kwargs[key] = kwargs[key] * scale_jitter * (1.0 + 0.1 * (rng.random() - 0.5))
        if kind == 'quad':
            vertices, edges = _quad_panel(**kwargs)
        else:
            vertices, edges = _trapezoid_panel(**kwargs)
        pattern.pattern['panels'][panel_name] = {
            'vertices': vertices,
            'edges': edges,
            'rotation': [float(r + 4.0 * (rng.random() - 0.5)) for r in rotation],
            'translation': [float(t * scale_jitter + 2.0 * (rng.random() - 0.5)) for t in translation],
        }
        panel_order.append(panel_name)

    pattern.pattern['panel_order'] = panel_order
    pattern.pattern['stitches'] = [
        [{'panel': a[0], 'edge': a[1]}, {'panel': b[0], 'edge': b[1]}]
        for a, b in tpl['stitches']
    ]
    pattern.parameters = pattern.spec['parameters'] = {
        'scale': {'value': float(scale_jitter), 'range': [0.8, 1.2], 'type': 'length'},
    }
    return pattern


# ---------------- mesh generation ----------------

def _sample_edge_polyline(vertices, edge, samples_per_edge=6):
    """Points along an edge (with quadratic-Bezier curvature if present)."""
    vertices = np.asarray(vertices, dtype=float)
    start, end = vertices[edge['endpoints'][0]], vertices[edge['endpoints'][1]]
    ts = np.linspace(0.0, 1.0, samples_per_edge, endpoint=False)
    if 'curvature' in edge:
        cx, cy = edge['curvature']
        direction = end - start
        perp = np.array([-direction[1], direction[0]])
        control = start + cx * direction + cy * perp
        pts = ((1 - ts)[:, None] ** 2 * start + 2 * (ts * (1 - ts))[:, None] * control
               + (ts[:, None] ** 2) * end)
    else:
        pts = (1 - ts)[:, None] * start + ts[:, None] * end
    return pts


def triangulate_panel(panel, grid_res=7):
    """Triangulate the (possibly curved) panel polygon in its local 2D frame.
    Returns (verts2d [V,2], faces [F,3] int)."""
    from matplotlib.path import Path as MplPath
    from scipy.spatial import Delaunay

    boundary = np.concatenate([
        _sample_edge_polyline(panel['vertices'], edge) for edge in panel['edges']
    ])
    low, high = boundary.min(axis=0), boundary.max(axis=0)
    xs = np.linspace(low[0], high[0], grid_res)
    ys = np.linspace(low[1], high[1], grid_res)
    grid = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)

    poly = MplPath(boundary)
    inside = poly.contains_points(grid, radius=-1e-6)
    points = np.concatenate([boundary, grid[inside]])

    tri = Delaunay(points)
    centroids = points[tri.simplices].mean(axis=1)
    keep = poly.contains_points(centroids)
    return points, tri.simplices[keep]


def pattern_to_mesh(pattern, bulge=3.0):
    """'Drape' the pattern: triangulate each panel, place it in 3D with a
    slight outward bulge along the panel normal. Returns
    (verts [V,3], faces [F,3], per-vertex labels list)."""
    all_verts, all_faces, labels = [], [], []
    offset = 0
    for panel_name in pattern.panel_order():
        if panel_name is None:
            continue
        panel = pattern.pattern['panels'][panel_name]
        verts2d, faces = triangulate_panel(panel)
        rot = rot_tools.euler_xyz_to_matrix(panel['rotation'])
        transl = np.asarray(panel['translation'], dtype=float)

        centroid = verts2d.mean(axis=0)
        extent = np.linalg.norm(verts2d - centroid, axis=1)
        extent = extent / (extent.max() + 1e-6)
        z_bulge = bulge * (1.0 - extent ** 2)  # max bulge in the middle
        local = np.concatenate([verts2d, z_bulge[:, None]], axis=1)
        world = local @ rot.T + transl

        all_verts.append(world)
        all_faces.append(faces + offset)
        labels.extend([panel_name] * len(world))
        offset += len(world)

    return np.concatenate(all_verts), np.concatenate(all_faces), labels


def write_obj(path, verts, faces):
    lines = ['# synthetic garment mesh']
    lines += [f'v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}' for v in verts]
    lines += [f'f {f[0] + 1} {f[1] + 1} {f[2] + 1}' for f in faces]
    Path(path).write_text('\n'.join(lines) + '\n')


# ---------------- dataset assembly ----------------

def generate_datapoint(out_dir, template_name, rng, panel_classifier=None,
                       name=None, with_scan=False):
    """One datapoint folder: specification.json + <name>_sim.obj +
    <name>_sim_segmentation.txt (+ optionally the scan-imitation variant —
    the reference dataset ships `*_scan_imitation.obj` meshes selected via
    `dataset.obj_filetag: scan`, reference docs/Running.md:27-28)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pattern = make_pattern(template_name, rng, panel_classifier=panel_classifier)
    pattern.name = name or out_dir.name

    with open(out_dir / 'specification.json', 'w') as f:
        json.dump(pattern.spec, f, indent=1)

    verts, faces, labels = pattern_to_mesh(pattern)
    # a few 'stitch' labels to exercise the segmentation-snap path
    labels = list(labels)
    for idx in rng.choice(len(labels), size=max(2, len(labels) // 50), replace=False):
        labels[idx] = 'stitch'
    write_obj(out_dir / f'{pattern.name}_sim.obj', verts, faces)
    (out_dir / f'{pattern.name}_sim_segmentation.txt').write_text('\n'.join(labels) + '\n')

    if with_scan:
        # scan imitation: per-vertex sensor noise + face dropout (holes where
        # a scanner saw nothing). Vertex count is unchanged, so the sim
        # segmentation labels stay valid for the scan mesh.
        scan_verts = verts + rng.normal(scale=0.4, size=verts.shape)
        keep = rng.random(len(faces)) > 0.25
        write_obj(out_dir / f'{pattern.name}_scan_imitation.obj',
                  scan_verts, faces[keep])
        (out_dir / f'{pattern.name}_scan_imitation_segmentation.txt'
         ).write_text('\n'.join(labels) + '\n')
    return pattern


def generate_dataset(root, folders=None, samples_per_folder=6, seed=0,
                     with_failures=True, with_scan=False):
    """A multi-folder synthetic dataset in the reference's layout.

    `folders`: dict folder_name -> template_name (the default covers the
    SEEN templates only; add e.g. ``{'dress_synth_300': 'dress'}`` for the
    unseen-type eval folders). Writes per-folder `dataset_properties.json`
    with the fields the dataset layer consumes (templates path,
    to_subfolders, sim fail lists). ``with_scan`` additionally emits
    `*_scan_imitation.obj` meshes for the `obj_filetag: scan` axis."""
    if folders is None:
        folders = {
            'tee_synth_300': 'tee',
            'skirt_synth_300': 'skirt',
            'jumpsuit_synth_300': 'jumpsuit',
        }
    root = Path(root)
    rng = np.random.default_rng(seed)
    for folder, template in folders.items():
        folder_dir = root / folder
        folder_dir.mkdir(parents=True, exist_ok=True)
        names = []
        for i in range(samples_per_folder):
            name = f'{template}_{i:05d}'
            generate_datapoint(folder_dir / name, template, rng, name=name,
                               with_scan=with_scan)
            names.append(name)

        fails = {'intersections': [], 'missing': []}
        if with_failures and len(names) > 3:
            fails['intersections'] = [names[-1]]  # mark the last one as a failed sim

        props = {
            'templates': f'assets/{template}.json',
            'to_subfolders': True,
            'size': samples_per_folder,
            'sim': {'stats': {'fails': fails}},
        }
        with open(folder_dir / 'dataset_properties.json', 'w') as f:
            json.dump(props, f, indent=2)
    return root


def augment_dataset_with_scans(root, folders=None, seed=1234):
    """Emit `*_scan_imitation.obj` variants for every datapoint of existing
    folders, WITHOUT touching the sim meshes or specs — a separate rng keeps
    previously generated data byte-identical, so models already trained on
    the sim meshes stay evaluable. Returns the number of datapoints
    augmented."""
    from ..preprocess import mesh as mesh_io

    root = Path(root)
    rng = np.random.default_rng(seed)
    count = 0
    folders = folders or [d.name for d in root.iterdir() if d.is_dir()]
    for folder in folders:
        for dp in sorted((root / folder).iterdir()):
            if not dp.is_dir():
                continue
            sims = sorted(dp.glob('*_sim.obj'))
            if not sims:
                continue
            sim = sims[0]
            name = sim.name[:-len('_sim.obj')]
            verts, faces = mesh_io.read_triangle_mesh(sim)
            scan_verts = verts + rng.normal(scale=0.4, size=verts.shape)
            keep = rng.random(len(faces)) > 0.25
            write_obj(dp / f'{name}_scan_imitation.obj', scan_verts, faces[keep])
            seg = dp / f'{name}_sim_segmentation.txt'
            if seg.exists():
                (dp / f'{name}_scan_imitation_segmentation.txt').write_text(
                    seg.read_text())
            count += 1
    return count


def panel_classes_for_templates(path=None):
    """Panel-classification JSON covering the synthetic templates (one class
    per distinct panel ROLE — unseen templates' panels join the classes the
    seen templates define, so the class count is unchanged by them)."""
    classes = {}
    for template_name, tpl in TEMPLATES.items():
        for spec in tpl['panels']:
            panel_name = spec[0]
            role = spec[4] if len(spec) > 4 else panel_name
            classes.setdefault(role, []).append([template_name, panel_name])
    if path is not None:
        with open(path, 'w') as f:
            json.dump(classes, f, indent=2)
    return classes
