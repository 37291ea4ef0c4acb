"""The traffic generator: clouds sampled from the repository's garment
meshes and the ground truth of a training batch, both from the seed.

Every traffic file (traffic/<name>.json) is read by these functions alone:

    entry            'serve' or 'train' (entries/<entry>.py drives it)
    batch, points    clouds per batch and points per cloud
    meshes           a glob, from the repository root, of the .obj meshes
    pool_batches     distinct batches made at set-up and cycled
    ...              the entry's own keys (warm-up, steps, trace window)

A cloud is drawn as users' clouds arrive: a mesh chosen uniformly, then
points uniform over its surface (each face by its area, a uniform point in
it), in the meshes' physical units. The clouds are made on the device in a
few large calls from a `torch.Generator` seeded from the run's seed.
"""
from __future__ import annotations

import glob

import numpy as np
import torch

from .common import ROOT


def read_obj(path):
    """(vertices (V, 3) float64, triangles (T, 3) int64) of a Wavefront
    .obj file: `v x y z` lines and `f` lines of 1-based ids (`i`, `i/t`,
    `i/t/n` or `i//n`), polygons split into fans."""
    vertices, triangles = [], []
    with open(path) as handle:
        for line in handle:
            if line.startswith('v '):
                vertices.append([float(v) for v in line.split()[1:4]])
            elif line.startswith('f '):
                ids = [int(token.split('/')[0]) - 1 for token in line.split()[1:]]
                triangles.extend([ids[0], ids[i], ids[i + 1]] for i in range(1, len(ids) - 1))
    return np.asarray(vertices, dtype=np.float64), np.asarray(triangles, dtype=np.int64)


class MeshBank:
    """Every mesh of a glob as one table of triangles on a device: corners
    (T, 3, 3) f32, the running sum of the triangles' areas (T,) f64, and
    each mesh's first triangle and total area."""

    def __init__(self, pattern, device):
        paths = sorted(glob.glob(str(ROOT / pattern)))
        if not paths:
            raise FileNotFoundError(f'traffic: no mesh matches {pattern}')
        corners, counts = [], []
        for path in paths:
            vertices, triangles = read_obj(path)
            corners.append(vertices[triangles])
            counts.append(len(triangles))
        corners = np.concatenate(corners)                               # (T, 3, 3)
        area = 0.5 * np.linalg.norm(np.cross(corners[:, 1] - corners[:, 0],
                                             corners[:, 2] - corners[:, 0]), axis=-1)
        cum = np.cumsum(area)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        start = np.where(first > 0, cum[first - 1], 0.0)
        self.paths = paths
        self.corners = torch.as_tensor(corners, dtype=torch.float32, device=device)
        self.cum_area = torch.as_tensor(cum, dtype=torch.float64, device=device)
        self.mesh_start = torch.as_tensor(start, dtype=torch.float64, device=device)
        self.mesh_area = torch.as_tensor(cum[np.cumsum(counts) - 1] - start,
                                         dtype=torch.float64, device=device)

    def __len__(self):
        return len(self.paths)

    def sample(self, n_clouds, n_points, generator):
        """(n_clouds, n_points, 3) f32 clouds in the meshes' units and the
        mesh id of each cloud (n_clouds,)."""
        device = self.corners.device
        mesh = torch.randint(len(self), (n_clouds,), generator=generator, device=device)
        u = torch.rand(n_clouds, n_points, generator=generator, device=device,
                       dtype=torch.float64)
        target = self.mesh_start[mesh][:, None] + u * self.mesh_area[mesh][:, None]
        face = torch.searchsorted(self.cum_area, target.reshape(-1), right=True)
        face = face.clamp_max(len(self.cum_area) - 1)
        r = torch.rand(2, n_clouds * n_points, generator=generator, device=device)
        s = torch.sqrt(r[0])
        tri = self.corners[face]                                          # (M, 3, 3)
        points = ((1 - s)[:, None] * tri[:, 0] + (s * (1 - r[1]))[:, None] * tri[:, 1]
                  + (s * r[1])[:, None] * tri[:, 2])
        return points.reshape(n_clouds, n_points, 3), mesh


def standardize(points, data_config):
    """Clouds in the units the model is trained in: (p - f_shift) / f_scale."""
    std = data_config['standardize']
    shift = torch.as_tensor(std['f_shift'], dtype=torch.float32, device=points.device)
    scale = torch.as_tensor(std['f_scale'], dtype=torch.float32, device=points.device)
    return (points - shift) / scale


def ground_truth(generator, batch, data_config):
    """Standardized ground truth in the dataset's shapes: 2-12 panels of
    3-14 edges, the pad vector beyond them; outlines, rotations and
    translations drawn at a half unit's spread."""
    device = generator.device
    P, L = data_config['max_pattern_len'], data_config['max_panel_len']
    std = data_config['standardize']
    shift = torch.as_tensor(std['gt_shift']['outlines'], dtype=torch.float32, device=device)
    scale = torch.as_tensor(std['gt_scale']['outlines'], dtype=torch.float32, device=device)
    pad = -shift / scale
    num_panels = torch.randint(2, 13, (batch,), generator=generator, device=device)
    edges = torch.randint(3, L + 1, (batch, P), generator=generator, device=device)
    num_edges = torch.where(torch.arange(P, device=device)[None] < num_panels[:, None], edges, 0)
    outlines = torch.randn(batch, P, L, data_config['element_size'], generator=generator,
                           device=device) * 0.5
    in_loop = torch.arange(L, device=device)[None, None] < num_edges[..., None]
    return {
        'outlines': torch.where(in_loop[..., None], outlines, pad),
        'rotations': torch.randn(batch, P, data_config['rotation_size'], generator=generator,
                                 device=device) * 0.5,
        'translations': torch.randn(batch, P, data_config['translation_size'],
                                    generator=generator, device=device) * 0.5,
        'num_edges': num_edges.int(), 'num_panels': num_panels.int()}


def serving_pool(traffic, seed, device):
    """(pool_batches, batch, points, 3) f32 clouds in physical units, made on
    `device` from `seed` and held in pinned host memory (the CPU: plain)."""
    from .common import derived_seed

    bank = MeshBank(traffic['meshes'], device)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 'clouds'))
    K, B, N = traffic['pool_batches'], traffic['batch'], traffic['points']
    clouds, _ = bank.sample(K * B, N, gen)
    host = clouds.reshape(K, B, N, 3).cpu()
    return host.pin_memory() if torch.device(device).type == 'cuda' else host


def training_pool(traffic, data_config, seed, device):
    """`pool_batches` distinct training batches on `device`, each
    {'features': standardized (batch, points, 3), 'ground_truth': {...}},
    from `seed`."""
    from .common import derived_seed

    bank = MeshBank(traffic['meshes'], device)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 'clouds'))
    K, B, N = traffic['pool_batches'], traffic['batch'], traffic['points']
    clouds, _ = bank.sample(K * B, N, gen)
    features = standardize(clouds, data_config).reshape(K, B, N, 3)
    gt_gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 'ground_truth'))
    return [{'features': features[i].contiguous(),
             'ground_truth': ground_truth(gt_gen, B, data_config)} for i in range(K)]
