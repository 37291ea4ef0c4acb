"""On-device mesh surface sampling: the `dataset.on_device_sampling` stage.

The port's counterpart of garment_pattern_estimation_tpu/preprocess/
device_sampling.py. The dataset ships each garment's mesh padded to a fixed
(vertex, face) capacity; this stage draws the point cloud on the mesh's
device just before the encoder: area-weighted barycentric surface points,
the `point_noise_w` gaussian noise, the nearest-vertex snap of the
segmentation labels, and feature standardization, batched over meshes and
always in float32.

Every drawing function is split in two: a draw-free core that takes the
uniform and gaussian draws as tensors (`sample_surface_from_draws`,
`BatchSampler.from_draws`), and a thin wrapper that makes those draws from a
`torch.Generator` on the mesh's device. The draws of the JAX package's
threefry keys can be fed to the core, which is how the tests hold this stage
to the reference; the generator's own draws differ from JAX's, their law is
the same.

The snap forms a (points x vertices) distance matrix, which XLA fuses into
its argmin. Eager PyTorch would materialize it, so `snap_to_vertices` runs
over chunks of query points with every intermediate below
`SNAP_CHUNK_BYTES`. Under `jit`, XLA also drops the snap wherever its labels
go unread; here the caller says whether it reads them (`labels=`).
"""
from __future__ import annotations

import numpy as np
import torch

# the largest (batch x points x vertices) float32 intermediate of the snap;
# three are alive at once (running sum, difference, its square)
SNAP_CHUNK_BYTES = 256 * 2 ** 20
# a consumer's sampling generator is seeded from its own step's stream plus
# this offset: the counterpart of the JAX package's fold_in(rng, 7)
SAMPLING_STREAM = 2 ** 32


def _rows(table, idx):
    """table[idx] per mesh: table (V, 3) with idx (...), or a batch table
    (B, V, 3) with idx (B, ...); int64 indices."""
    idx = idx.long()
    if table.dim() == 2:
        return table[idx]
    batch = torch.arange(table.shape[0], device=table.device).view(
        -1, *([1] * (idx.dim() - 1)))
    return table[batch, idx]


def face_areas(verts, faces):
    """(V, 3) x (F, 3) int -> (F,) triangle areas, or batched (B, V, 3) x
    (B, F, 3) -> (B, F). Degenerate (padded) faces, e.g. the (0, 0, 0) rows
    of `pad_mesh`, get zero area and are never sampled."""
    tri = _rows(verts, faces)                                # (..., F, 3, 3)
    cross = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                               tri[..., 2, :] - tri[..., 0, :], dim=-1)
    return 0.5 * torch.linalg.vector_norm(cross, dim=-1)


def sample_surface_from_draws(verts, faces, face_u, u, v, noise=None, noise_w=0.0):
    """The draw-free core of `sample_surface`, for one mesh (verts (V, 3),
    faces (F, 3), draws (N,), noise (N, 3)) or a batch of meshes padded to
    one capacity (verts (B, V, 3), faces (B, F, 3), draws (B, N), noise
    (B, N, 3)).

    `face_u`, `u`, `v` are uniform draws in [0, 1): `face_u` picks the face
    by inverse CDF of the float32 cumulative areas (`searchsorted` on the
    right side, clipped to F - 1), `u` and `v` are folded onto the simplex
    where u + v > 1. `noise` is a standard normal draw, added times
    `noise_w` only when `noise_w` is non-zero. Returns (points (..., N, 3),
    face ids (..., N) int64)."""
    verts = verts.float()
    areas = face_areas(verts, faces)
    cdf = torch.cumsum(areas, dim=-1)
    draws = face_u * cdf[..., -1:]
    face_ids = torch.searchsorted(cdf, draws.contiguous(), right=True).clamp_(
        0, faces.shape[-2] - 1)

    flip = u + v > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    w = 1.0 - u - v

    tri = _rows(verts, _rows(faces, face_ids))               # (..., N, 3, 3)
    pts = (w[..., None] * tri[..., 0, :] + u[..., None] * tri[..., 1, :]
           + v[..., None] * tri[..., 2, :])
    if noise_w:
        pts = pts + noise_w * noise
    return pts, face_ids


def surface_draws(generator, shape, device, with_noise):
    """The four draws of one sampling, in this order: face uniform, u, v
    (each of `shape`) and the gaussian noise (`shape` + (3,), None without
    `with_noise`), from `generator` on `device` (None: torch's default
    generator of that device)."""
    face_u = torch.rand(shape, generator=generator, device=device)
    u = torch.rand(shape, generator=generator, device=device)
    v = torch.rand(shape, generator=generator, device=device)
    noise = torch.randn(tuple(shape) + (3,), generator=generator, device=device) \
        if with_noise else None
    return face_u, u, v, noise


def sample_surface(generator, verts, faces, num_points, noise_w=0.0):
    """Area-weighted uniform surface samples of ONE mesh, drawn from
    `generator` on the mesh's device.

    Args:
      generator: a torch.Generator on verts' device (None: the default one).
      verts: (V, 3) float vertices (padding rows are fine if unreferenced).
      faces: (F, 3) int vertex ids; pad with degenerate faces (zero area).
      num_points: sample count.
      noise_w: gaussian noise weight (the dataset's `point_noise_w`).

    Returns (points (num_points, 3), face_ids (num_points,))."""
    draws = surface_draws(generator, (num_points,), verts.device, bool(noise_w))
    return sample_surface_from_draws(verts, faces, *draws, noise_w=noise_w)


def sample_surface_batched(generator, verts, faces, num_points, noise_w=0.0):
    """`sample_surface` over a batch of meshes padded to one capacity:
    verts (B, V, 3), faces (B, F, 3). Returns (B, num_points, 3) points and
    (B, num_points) face ids."""
    draws = surface_draws(generator, (verts.shape[0], num_points), verts.device,
                          bool(noise_w))
    return sample_surface_from_draws(verts, faces, *draws, noise_w=noise_w)


def snap_to_vertices(points, verts, valid_verts=None):
    """Nearest-vertex index per point (the segmentation-label transfer of
    nn/data/datasets.py:863-905, on the device): points (N, 3) and verts
    (V, 3), or batched (B, N, 3) and (B, V, 3); `valid_verts` ((V,) or
    (B, V) bool) masks padded vertex rows out of the argmin, which takes the
    first index on ties. The squared distance is summed per dimension in
    dimension order, as the JAX package's `sum((p - v) ** 2, -1)`; the
    |p|^2 - 2 p.v + |v|^2 expansion would round differently and move the
    argmin on near-equidistant vertices. Runs over chunks of points (and of
    meshes) so that no intermediate exceeds SNAP_CHUNK_BYTES. Returns int64
    ids of points' leading shape."""
    if points.dim() == 2:
        valid = None if valid_verts is None else valid_verts[None]
        return snap_to_vertices(points[None], verts[None], valid)[0]
    batch, n, _ = points.shape
    row_bytes = verts.shape[1] * 4
    if batch > 1 and batch * row_bytes > SNAP_CHUNK_BYTES:
        return torch.cat([snap_to_vertices(
            points[b:b + 1], verts[b:b + 1],
            None if valid_verts is None else valid_verts[b:b + 1]) for b in range(batch)])
    chunk = max(1, SNAP_CHUNK_BYTES // (batch * row_bytes))
    out = []
    for start in range(0, n, chunk):
        p = points[:, start:start + chunk]
        d = None
        for dim in range(3):
            diff = p[:, :, None, dim] - verts[:, None, :, dim]
            if d is None:
                d = diff * diff
            else:
                d += diff * diff
            del diff
        if valid_verts is not None:
            d = d.masked_fill_(~valid_verts[:, None, :], float('inf'))
        out.append(torch.argmin(d, dim=-1))
        del d
    return torch.cat(out, dim=1)


def pad_mesh(verts, faces, v_cap, f_cap):
    """Host-side helper: pad one mesh to (v_cap, f_cap) capacity with
    zero vertices and degenerate (0,0,0) faces — zero area, never
    sampled. Returns (verts, faces, n_verts) as numpy arrays."""
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    out_v = np.zeros((v_cap, 3), np.float32)
    out_v[:len(verts)] = verts
    out_f = np.zeros((f_cap, 3), np.int32)
    out_f[:len(faces)] = faces
    return out_v, out_f, len(verts)


class BatchSampler:
    """The `dataset.on_device_sampling` pipeline stage over a collated mesh
    batch {'verts' (B, Vcap, 3), 'faces' (B, Fcap, 3), 'n_verts' (B,),
    'vert_labels' (B, Vcap) int (-1 where no segmentation exists)}, on the
    batch's device, in float32: area-weighted surface sampling with
    `point_noise_w` noise, the nearest-vertex snap of the labels, and
    feature standardization.

    `sampler(generator, mesh_features, labels=True)` returns standardized
    points (B, N, 3) and per-point class labels (B, N) int32 (zeros where
    the batch carries no labels), or None for the labels when `labels` is
    false: the snap then does not run (the JAX package's jit drops it
    wherever its labels go unread)."""

    def __init__(self, num_points, noise_w, f_shift, f_scale):
        self.num_points = int(num_points)
        self.noise_w = float(noise_w)
        self._stats = {'cpu': (torch.tensor(f_shift, dtype=torch.float32),
                               torch.tensor(f_scale, dtype=torch.float32))}

    def stats(self, device):
        """(f_shift, f_scale) float32 tensors on `device`."""
        key = str(torch.device(device))
        if key not in self._stats:
            self._stats[key] = tuple(t.to(device) for t in self._stats['cpu'])
        return self._stats[key]

    def draws(self, generator, batch, device):
        """The stage's draws for `batch` meshes (`surface_draws`)."""
        return surface_draws(generator, (batch, self.num_points), device, bool(self.noise_w))

    def from_draws(self, mesh_features, face_u, u, v, noise=None, labels=True):
        """The draw-free stage: draws (B, N) and noise (B, N, 3) given."""
        verts = torch.as_tensor(mesh_features['verts']).float()
        faces = torch.as_tensor(mesh_features['faces'], device=verts.device)
        pts, _ = sample_surface_from_draws(verts, faces, face_u, u, v, noise, self.noise_w)
        segm = None
        if labels:
            n_verts = torch.as_tensor(mesh_features['n_verts'], device=verts.device)
            valid = torch.arange(verts.shape[1], device=verts.device) < n_verts[:, None]
            idx = snap_to_vertices(pts, verts, valid)
            vert_labels = torch.as_tensor(mesh_features['vert_labels'], device=verts.device)
            segm = torch.gather(vert_labels.long(), 1, idx).clamp_min_(0).int()
        shift, scale = self.stats(verts.device)
        return (pts - shift) / scale, segm

    def __call__(self, generator, mesh_features, labels=True):
        verts = torch.as_tensor(mesh_features['verts'])
        draws = self.draws(generator, verts.shape[0], verts.device)
        return self.from_draws(mesh_features, *draws, labels=labels)


def make_batch_sampler(data_config):
    """The `dataset.on_device_sampling` stage of a dataset config
    (`mesh_samples`, `point_noise_w`, and the `standardize` statistics,
    without which it raises ValueError)."""
    stats = data_config.get('standardize')
    if not stats or 'f_shift' not in stats:
        raise ValueError(
            'make_batch_sampler::feature standardization stats missing — call '
            'dataset.standardize() (or put them in the config) first')
    return BatchSampler(data_config['mesh_samples'],
                        data_config.get('point_noise_w', 0) or 0,
                        stats['f_shift'], stats['f_scale'])


def maybe_batch_sampler(data_config):
    """`make_batch_sampler` when the config enables on-device sampling,
    else None — the one test every consumer (trainer, eval, predict)
    makes."""
    if data_config.get('on_device_sampling'):
        return make_batch_sampler(data_config)
    return None


def reads_segmentation(loss):
    """Whether `loss` reads the ground truth's 'segmentation' (the only
    consumer of the snap's labels)."""
    return 'segmentation' in getattr(loss, 'l_components', ())
