"""The traffic generator: the same tensors for one seed, others for two,
and clouds with the statistics of the meshes they are drawn from."""
import json

import numpy as np
import torch

from benchmark import common, traffic

MESHES = 'parity_run/data_big/*/*/*_sim.obj'
TRAFFIC = {'meshes': MESHES, 'pool_batches': 2, 'batch': 3, 'points': 500}
DATA = json.loads((common.HERE / 'configs' / 'att.json').read_text())['data']


def test_obj_reader_splits_polygons(tmp_path):
    path = tmp_path / 'quad.obj'
    path.write_text('v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n')
    vertices, triangles = traffic.read_obj(path)
    assert vertices.shape == (4, 3)
    assert triangles.tolist() == [[0, 1, 2], [0, 2, 3]]


def test_serving_pool_is_fixed_by_the_seed():
    a = traffic.serving_pool(TRAFFIC, 5, 'cpu')
    b = traffic.serving_pool(TRAFFIC, 5, 'cpu')
    c = traffic.serving_pool(TRAFFIC, 6, 'cpu')
    assert a.shape == (2, 3, 500, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_training_pool_is_fixed_by_the_seed():
    a = traffic.training_pool(TRAFFIC, DATA, 5, 'cpu')
    b = traffic.training_pool(TRAFFIC, DATA, 5, 'cpu')
    c = traffic.training_pool(TRAFFIC, DATA, 2 ** 31 + 11, 'cpu')
    for x, y in zip(a, b):
        assert torch.equal(x['features'], y['features'])
        for key in x['ground_truth']:
            assert torch.equal(x['ground_truth'][key], y['ground_truth'][key])
    assert not torch.equal(a[0]['features'], c[0]['features'])
    assert not torch.equal(a[0]['ground_truth']['outlines'], c[0]['ground_truth']['outlines'])
    gt = a[0]['ground_truth']
    assert gt['outlines'].shape == (3, 23, 14, 4)
    assert ((gt['num_panels'] >= 2) & (gt['num_panels'] <= 12)).all()
    edges = gt['num_edges'][gt['num_edges'] > 0]
    assert ((edges >= 3) & (edges <= 14)).all()


def test_clouds_follow_the_meshes_surface():
    """Points lie on the chosen mesh's triangles; over many clouds their mean
    and spread are the area-weighted ones of the meshes, within sampling."""
    bank = traffic.MeshBank(MESHES, 'cpu')
    gen = torch.Generator().manual_seed(3)
    clouds, mesh = bank.sample(600, 400, gen)
    tri = bank.corners.double()
    area = 0.5 * torch.linalg.norm(torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                                               dim=-1), dim=-1)
    centroid = tri.mean(1)
    pts = clouds.reshape(-1, 3).double()
    extent = (tri.reshape(-1, 3).max(0).values - tri.reshape(-1, 3).min(0).values)
    # meshes are drawn uniformly per cloud, points by area within a mesh:
    # each mesh's area-weighted mean weighs the same
    per_mesh = []
    start = 0
    for path in bank.paths:
        _, triangles = traffic.read_obj(path)
        a, c = area[start:start + len(triangles)], centroid[start:start + len(triangles)]
        per_mesh.append((a[:, None] * c).sum(0) / a.sum())
        start += len(triangles)
    expected = torch.stack(per_mesh).mean(0)
    assert torch.all((pts.mean(0) - expected).abs() < 0.02 * extent), (pts.mean(0), expected)
    assert int(mesh.min()) >= 0 and int(mesh.max()) < len(bank)


def test_standardize_is_the_data_configs():
    x = torch.tensor([[[1.0, 2.0, 3.0]]])
    std = DATA['standardize']
    expected = (np.array([1.0, 2.0, 3.0]) - np.array(std['f_shift'])) / np.array(std['f_scale'])
    assert np.allclose(traffic.standardize(x, DATA)[0, 0].numpy(), expected)
