"""The port's on-device sampling stage (`dataset.on_device_sampling`)
against the JAX package's: garment_pattern_estimation_torch/preprocess/
device_sampling.py beside garment_pattern_estimation_tpu/preprocess/
device_sampling.py, the dataset's mesh features, and the mode through
`Trainer.fit`, `eval_metrics` and `make_predict_fn`.

The stage is random, so it is held to the reference by replaying the JAX
package's own threefry draws (`jax.random.split(key, 4)` per mesh, the keys
split over the batch as its vmapped sampler splits them) through the port's
draw-free core. Inputs are made with numpy from seeds.

Bars and their reasons:
  * face areas: 1e-6 of the largest area (cross products and norms in
    another order);
  * face ids: equal except where a draw lies within 1e-6 x total of a step
    of the cumulative areas: XLA's float32 cumsum and torch's round
    differently, so such a draw may land on the neighbouring face;
  * points: 1e-5 of the mesh's extent where the face ids agree;
  * labels: equal except near ties of the two vertices' float64 distances
    (1e-5 relative);
  * pad_mesh and the dataset's mesh features: equal bytes (numpy on both
    sides); the standardization statistics within 1e-6 (f64 sums cast to
    f32 on both sides, as tests/test_torch_data.py);
  * one training step: loss within 5e-4 relative, tests/test_torch_fit.py's
    bar.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_torch import data as pt_data
from garment_pattern_estimation_torch import experiment as pt_experiment
from garment_pattern_estimation_torch.models import build_model as pt_build_model
from garment_pattern_estimation_torch.models.flax_import import state_dict_from_flax
from garment_pattern_estimation_torch.preprocess import device_sampling as pt_ds
from garment_pattern_estimation_torch.train import Trainer, eval_metrics, make_predict_fn
from garment_pattern_estimation_tpu import data as jx_data
from garment_pattern_estimation_tpu.models import build_model as jx_build_model
from garment_pattern_estimation_tpu.preprocess import device_sampling as jx_ds
from garment_pattern_estimation_tpu.preprocess.mesh import sample_mesh_points
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer

torch.set_num_threads(1)

FOLDERS = ['tee_synth_300', 'skirt_synth_300']
SPLIT = {'valid_per_type': 1, 'test_per_type': 1, 'type': 'count', 'random_seed': 10}
NN = {'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 1,
      'pattern_encoding_size': 16, 'pattern_hidden_size': 16, 'pattern_n_layers': 1,
      'EConv_hidden': 10, 'EConv_feature': 8, 'k_neighbors': 4, 'conv_depth': 1,
      'skip_connections': True, 'local_attention': True, 'lstm_init': 'zeros'}
LOSS = {'loss_components': ['shape', 'loop'], 'quality_components': ['shape', 'discrete'],
        'panel_order_inariant_loss': False, 'panel_origin_invariant_loss': False,
        'epoch_with_stitches': 100}
SEGM_LOSS = dict(LOSS, loss_components=['shape', 'loop', 'segmentation'])
SETUP = {'batch_size': 3, 'epochs': 2, 'random_seed': 3, 'learning_rate': 2e-3,
         'optimizer': 'Adam', 'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'},
         'early_stopping': {'window': 1e-8, 'patience': 50}}
BOUNDARY_REL, POINT_REL, TIE_REL, STATS_TOL, STEP_RTOL = 1e-6, 1e-5, 1e-5, 1e-6, 5e-4


def _config(root, **extra):
    return {'data_folders': FOLDERS, 'mesh_samples': 60, 'on_device_sampling': True,
            'mesh_vertex_cap': 256, 'mesh_face_cap': 512, 'point_noise_w': 0.01,
            'panel_classification': str(root / 'panel_classes.json'), **extra}


def _random_mesh(rng, n_verts, n_faces, v_cap, f_cap):
    """bench.py's construction: gaussian vertices x 20, random faces, padded."""
    verts = (rng.normal(size=(n_verts, 3)) * 20).astype(np.float32)
    faces = rng.integers(0, n_verts, (n_faces, 3)).astype(np.int32)
    return jx_ds.pad_mesh(verts, faces, v_cap, f_cap)


def _jax_draws(key, num_points):
    """The four draws of jax sample_surface(key, ...), as numpy."""
    k_face, k_u, k_v, k_noise = jax.random.split(key, 4)
    return (np.array(jax.random.uniform(k_face, (num_points,))),
            np.array(jax.random.uniform(k_u, (num_points,))),
            np.array(jax.random.uniform(k_v, (num_points,))),
            np.array(jax.random.normal(k_noise, (num_points, 3))))


def _batch_draws(key, batch, num_points):
    """The draws of jax make_batch_sampler's vmapped stage under `key`."""
    per_mesh = [_jax_draws(k, num_points) for k in jax.random.split(key, batch)]
    return [torch.from_numpy(np.stack(d)) for d in zip(*per_mesh)]


def _check_face_ids(ours, theirs, face_u, verts, faces):
    """Face ids equal except for draws within BOUNDARY_REL x total of a step
    of the JAX cumulative areas. Returns the agreeing mask."""
    cdf = np.asarray(jnp.cumsum(jx_ds.face_areas(jnp.asarray(verts), jnp.asarray(faces))))
    draws = face_u * cdf[-1]
    same = ours == theirs
    gap = np.abs(draws[~same, None] - cdf[None, :]).min(axis=1)
    assert np.all(gap <= BOUNDARY_REL * cdf[-1]), gap
    return same


def _extent(verts, n_verts):
    return float(np.ptp(verts[:n_verts], axis=0).max())


def test_face_areas_match_jax(rng):
    verts, faces, _ = _random_mesh(rng, 300, 500, 512, 640)
    ours = pt_ds.face_areas(torch.from_numpy(verts), torch.from_numpy(faces)).numpy()
    theirs = np.asarray(jx_ds.face_areas(jnp.asarray(verts), jnp.asarray(faces)))
    assert np.abs(ours - theirs).max() <= 1e-6 * theirs.max()
    assert np.all(ours[500:] == 0)                     # padded faces: zero area
    batched = pt_ds.face_areas(torch.from_numpy(np.stack([verts, 2 * verts])),
                               torch.from_numpy(np.stack([faces, faces]))).numpy()
    np.testing.assert_array_equal(batched[0], ours)


@pytest.mark.parametrize('noise_w', [0.0, 0.01])
def test_sample_surface_from_jax_draws(rng, noise_w):
    """The core fed JAX's draws gives JAX's face ids and points."""
    verts, faces, n_verts = _random_mesh(rng, 300, 500, 512, 640)
    key = jax.random.PRNGKey(7)
    theirs, their_ids = jx_ds.sample_surface(key, jnp.asarray(verts), jnp.asarray(faces),
                                             2000, noise_w)
    face_u, u, v, noise = _jax_draws(key, 2000)
    ours, our_ids = pt_ds.sample_surface_from_draws(
        torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(face_u),
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(noise), noise_w)
    same = _check_face_ids(our_ids.numpy(), np.asarray(their_ids), face_u, verts, faces)
    gap = np.abs(ours.numpy() - np.asarray(theirs))[same].max()
    assert gap <= POINT_REL * _extent(verts, n_verts)


def test_batch_sampler_from_jax_draws(rng):
    """make_batch_sampler: standardized points and snapped labels of the
    port's stage on JAX's draws against the JAX stage under the same key."""
    B, N = 4, 500
    meshes = [_random_mesh(rng, 200, 400, 256, 512) for _ in range(B)]
    features = {'verts': np.stack([m[0] for m in meshes]),
                'faces': np.stack([m[1] for m in meshes]),
                'n_verts': np.array([m[2] for m in meshes], np.int32),
                'vert_labels': rng.integers(-1, 6, (B, 256)).astype(np.int32)}
    config = {'mesh_samples': N, 'point_noise_w': 0.01,
              'standardize': {'f_shift': [0.5, -3.0, 1.0], 'f_scale': [16.0, 30.0, 9.5]}}
    key = jax.random.PRNGKey(3)
    theirs, their_labels = jax.jit(jx_ds.make_batch_sampler(config))(
        key, {k: jnp.asarray(v) for k, v in features.items()})
    theirs, their_labels = np.asarray(theirs), np.asarray(their_labels)
    draws = _batch_draws(key, B, N)
    sampler = pt_ds.make_batch_sampler(config)
    ours, labels = sampler.from_draws({k: torch.from_numpy(v) for k, v in features.items()},
                                      *draws)
    assert ours.dtype == torch.float32 and labels.dtype == torch.int32
    ours, labels = ours.numpy(), labels.numpy()
    scale = np.asarray(config['standardize']['f_scale'])
    for b in range(B):
        verts, faces, n_verts = meshes[b]
        _, our_ids = pt_ds.sample_surface_from_draws(
            torch.from_numpy(verts), torch.from_numpy(faces), draws[0][b], draws[1][b],
            draws[2][b])
        _, their_ids = jx_ds.sample_surface(jax.random.split(key, B)[b], jnp.asarray(verts),
                                            jnp.asarray(faces), N)
        same = _check_face_ids(our_ids.numpy(), np.asarray(their_ids), draws[0][b].numpy(),
                               verts, faces)
        gap = np.abs((ours[b] - theirs[b]) * scale)[same].max()
        assert gap <= POINT_REL * _extent(verts, n_verts)
        # labels: equal except where the two snapped vertices are near ties
        raw = theirs[b] * scale + np.asarray(config['standardize']['f_shift'])
        differ = np.flatnonzero(labels[b] != their_labels[b])
        d = ((raw[:, None, :].astype(np.float64) - verts[None, :n_verts]) ** 2).sum(-1)
        best = d[differ].min(axis=1)
        second = np.partition(d[differ], 1, axis=1)[:, 1] if len(differ) else best
        assert np.all(second - best <= TIE_REL * np.maximum(best, 1e-12)), differ
    assert (labels >= 0).all() and (labels > 0).any()
    _, no_labels = sampler.from_draws({k: torch.from_numpy(v) for k, v in features.items()},
                                      *draws, labels=False)
    assert no_labels is None


def test_pad_mesh_is_byte_equal(rng):
    verts = rng.normal(size=(37, 3))
    faces = rng.integers(0, 37, (51, 3))
    for ours, theirs in zip(pt_ds.pad_mesh(verts, faces, 64, 80),
                            jx_ds.pad_mesh(verts, faces, 64, 80)):
        if isinstance(theirs, np.ndarray):
            assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
        else:
            assert ours == theirs


def test_sampler_needs_standardization_stats():
    with pytest.raises(ValueError, match='standardization stats missing'):
        pt_ds.make_batch_sampler({'mesh_samples': 10})
    assert pt_ds.maybe_batch_sampler({'mesh_samples': 10}) is None


# ---- the JAX package's statistical and masking tests, ported ----

def _two_tri_mesh():
    # one small + one 4x-larger triangle, coplanar
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [2, 0, 0], [4, 0, 0], [2, 2, 0]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return verts, faces


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_area_weighting_and_support():
    verts, faces = _two_tri_mesh()
    areas = pt_ds.face_areas(torch.from_numpy(verts), torch.from_numpy(faces)).numpy()
    np.testing.assert_allclose(areas, [0.5, 2.0], atol=1e-6)
    pts, fids = pt_ds.sample_surface(_gen(0), torch.from_numpy(verts),
                                     torch.from_numpy(faces), 4000)
    assert abs((fids.numpy() == 1).mean() - 0.8) < 0.03   # 2.0 / 2.5 area share
    pts = pts.numpy()
    assert np.all(pts[:, 2] == 0)                         # on the z=0 plane
    assert pts[:, 0].min() >= 0 and pts[:, 0].max() <= 4 + 1e-5


def test_barycentric_mean_matches_host_sampler():
    """Mean of uniform surface samples ~= area-weighted centroid: the
    device sampler against the (seeded) host sampler, statistically."""
    verts, faces = _two_tri_mesh()
    host = sample_mesh_points(8000, verts, faces, seed=3)
    dev = pt_ds.sample_surface(_gen(3), torch.from_numpy(verts), torch.from_numpy(faces),
                               8000)[0].numpy()
    np.testing.assert_allclose(host.mean(0), dev.mean(0), atol=0.05)
    np.testing.assert_allclose(host.std(0), dev.std(0), atol=0.05)


def test_padding_is_never_sampled():
    verts, faces = _two_tri_mesh()
    pv, pf, _ = pt_ds.pad_mesh(verts, faces, v_cap=16, f_cap=10)
    _, fids = pt_ds.sample_surface(_gen(1), torch.from_numpy(pv), torch.from_numpy(pf), 2000)
    assert int(fids.max()) <= 1                           # degenerate pad faces: zero area


def test_batched_sampling():
    verts, faces = _two_tri_mesh()
    pv, pf, _ = pt_ds.pad_mesh(verts, faces, 8, 4)
    vb = torch.from_numpy(np.stack([pv, pv * 2.0]))
    fb = torch.from_numpy(np.stack([pf] * 2))
    pts, fids = pt_ds.sample_surface_batched(_gen(2), vb, fb, 500, 0.0)
    assert pts.shape == (2, 500, 3) and fids.shape == (2, 500)
    # the second mesh is scaled 2x: its samples live in the scaled range
    assert float(pts[1].max()) > float(pts[0].max())


def test_snap_to_vertices_masks_padding(monkeypatch):
    verts, faces = _two_tri_mesh()
    pv, _, n_verts = pt_ds.pad_mesh(verts, faces, 16, 10)
    valid = torch.arange(16) < n_verts
    idx = pt_ds.snap_to_vertices(torch.from_numpy(verts[:3] + 0.01), torch.from_numpy(pv),
                                 valid)
    np.testing.assert_array_equal(idx.numpy(), [0, 1, 2])
    # the padded zero vertices would capture near-origin points unmasked;
    # masked, the first real vertex wins the tie at the origin
    idx = pt_ds.snap_to_vertices(torch.tensor([[0.001, 0.001, 0.0]]), torch.from_numpy(pv),
                                 valid)
    assert int(idx[0]) == 0
    # chunked over points and meshes: the same ids as one pass
    points = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 50, 3)).astype(np.float32))
    verts3 = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 16, 3)).astype(np.float32))
    whole = pt_ds.snap_to_vertices(points, verts3)
    monkeypatch.setattr(pt_ds, 'SNAP_CHUNK_BYTES', 2 * 16 * 4)
    np.testing.assert_array_equal(pt_ds.snap_to_vertices(points, verts3).numpy(), whole.numpy())


# ---- the dataset's mesh features and the mode through training ----

@pytest.fixture(scope='module')
def wrappers(synthetic_dataset_root):
    """An on-device-sampling DatasetWrapper on each side, split, batched (4)
    and standardized."""
    root = synthetic_dataset_root
    out = []
    for data in (jx_data, pt_data):
        dataset = data.Garment3DPatternFullDataset(root, _config(root), gt_caching=True,
                                                   feature_caching=True)
        wrapper = data.DatasetWrapper(dataset)
        wrapper.load_split(dict(SPLIT))
        wrapper.new_loaders(4, shuffle_train=True)
        wrapper.standardize_data()
        out.append(wrapper)
    return out


def test_mesh_features_match_jax(wrappers):
    jx_w, pt_w = wrappers
    jx_set, pt_set = jx_w.dataset, pt_w.dataset
    assert len(pt_set) == len(jx_set) > 0
    assert pt_set.config['feature_size'] == jx_set.config['feature_size'] == 60
    for i in range(len(jx_set)):
        ours, theirs = pt_set[i]['features'], jx_set[i]['features']
        assert set(ours) == set(theirs) == {'verts', 'faces', 'n_verts', 'vert_labels'}
        for key, value in theirs.items():
            value = np.asarray(value)
            assert ours[key].dtype == value.dtype and ours[key].tobytes() == value.tobytes(), key
        assert 'segmentation' not in pt_set[i]['ground_truth']
    assert (pt_set[0]['features']['vert_labels'] >= 0).any()


def test_mesh_standardization_matches_jax(wrappers):
    """The statistics come from host-sampled training clouds on both sides,
    and the feature transform leaves mesh dicts alone."""
    jx_stats = wrappers[0].dataset.config['standardize']
    pt_stats = wrappers[1].dataset.config['standardize']
    for key in ('f_shift', 'f_scale'):
        np.testing.assert_allclose(pt_stats[key], jx_stats[key], atol=STATS_TOL)
    for group in ('gt_shift', 'gt_scale'):
        for key, value in jx_stats[group].items():
            np.testing.assert_allclose(pt_stats[group][key], value, atol=STATS_TOL)
    batch = next(iter(wrappers[1].loaders.validation))
    assert batch['features']['verts'].shape == (len(batch['name']), 256, 3)
    assert batch['features']['verts'].dtype == torch.float32
    assert batch['features']['n_verts'].dtype == torch.int32


def test_train_step_on_jax_draws_matches_jax(wrappers):
    """One training step with the segmentation loss: the port's step on the
    cloud its stage makes from JAX's draws, against the JAX step (its
    sampler inside), from the same weights."""
    jx_w, _ = wrappers
    config = jx_w.dataset.config
    batch = next(iter(jx_w.loaders.validation))
    size = len(batch['name'])
    jx_model = jx_build_model('GarmentSegmentPattern3D', config, NN, SEGM_LOSS,
                              use_pallas=False)
    # jitted: an eager flax init takes about 10 s
    init = jax.jit(jx_model.init_variables)
    points = np.random.default_rng(0).normal(size=(2, config['mesh_samples'], 3))
    variables = jax.tree_util.tree_map(
        np.array, init(jax.random.PRNGKey(1), jnp.asarray(points, jnp.float32)))

    trainer = JaxTrainer.__new__(JaxTrainer)
    trainer.setup, trainer._step_cache = dict(SETUP), {}
    trainer.device_sampler = jx_ds.maybe_batch_sampler(config)
    tx = trainer._make_optimizer(1)
    step = trainer._train_step_fn(jx_model, tx, (False, False), size)
    rng = jax.random.PRNGKey(5)
    params = jax.tree_util.tree_map(jnp.array, variables['params'])
    stats = jax.tree_util.tree_map(jnp.array, variables['batch_stats'])
    placed = jax.tree_util.tree_map(jnp.asarray, {'features': batch['features'],
                                                  'ground_truth': batch['ground_truth']})
    *_, their_loss, their_terms = step(params, stats, tx.init(params), placed, rng)

    sampler = pt_ds.make_batch_sampler(config)
    draws = _batch_draws(jax.random.fold_in(rng, 7), size, config['mesh_samples'])
    points, segm = sampler.from_draws(
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch['features'].items()}, *draws)
    gt = {k: torch.from_numpy(np.asarray(v)) for k, v in batch['ground_truth'].items()}
    model = pt_build_model('GarmentSegmentPattern3D', config, NN, SEGM_LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    ours = Trainer(SETUP, device='cpu')
    ours.make_optimizer(model, 1)
    loss, terms = ours.train_step(model, {'features': points,
                                          'ground_truth': dict(gt, segmentation=segm)}, 0)
    assert 'segm_loss' in terms and float(terms['segm_loss']) > 0
    np.testing.assert_allclose(float(terms['segm_loss']), float(their_terms['segm_loss']),
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(float(loss), float(their_loss), rtol=STEP_RTOL)


def _fit(root, out, loss, monkeypatch, **setup):
    """A tiny on-device-sampling fit on the CPU; records every draw of the
    stage and every snap."""
    record = {'draws': [], 'snaps': 0}
    draws, snap = pt_ds.BatchSampler.draws, pt_ds.snap_to_vertices

    def spy_draws(self, generator, batch, device):
        out = draws(self, generator, batch, device)
        record['draws'].append(out[0].clone())
        return out

    def spy_snap(*args, **kwargs):
        record['snaps'] += 1
        return snap(*args, **kwargs)
    monkeypatch.setattr(pt_ds.BatchSampler, 'draws', spy_draws)
    monkeypatch.setattr(pt_ds, 'snap_to_vertices', spy_snap)
    dataset = pt_data.Garment3DPatternFullDataset(root, _config(root), gt_caching=True,
                                                  feature_caching=True)
    exp = pt_experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'ods', 'run_name': 'port'}}, output_root=out)
    trainer = Trainer(dict(SETUP, **setup), exp, dataset, dict(SPLIT), device='cpu')
    trainer.init_randomizer()
    model = pt_build_model('GarmentSegmentPattern3D', dataset.config, NN, loss, device='cpu')
    trainer.fit(model)
    return trainer, model, exp, record


def test_on_device_sampling_trains_and_evaluates(synthetic_dataset_root, tmp_path,
                                                 monkeypatch):
    """The mode end to end on the CPU, with the segmentation loss: each
    training step draws from its own stream (a new cloud every step), each
    validation pass from its epoch's stream (the same draws for every batch
    of the epoch), the snap runs and its labels reach the loss; then
    eval_metrics and make_predict_fn on mesh dicts."""
    trainer, model, exp, record = _fit(synthetic_dataset_root, tmp_path, SEGM_LOSS,
                                       monkeypatch)
    assert trainer.device_sampler is not None
    records = [json.loads(line) for line in
               (exp.run_dir() / 'metrics.jsonl').read_text().splitlines()]
    steps = [r for r in records if 'batch' in r]
    assert len(steps) == trainer.step_count == 4      # 2 epochs of 2 batches of 3
    assert all(np.isfinite(r['loss']) and r['segm_loss'] > 0 for r in steps)
    spe = len(trainer.datawrapper.loaders.train)
    n_valid = len(trainer.datawrapper.loaders.validation)
    shape = record['draws'][0].shape
    expected = []
    for epoch in range(2):
        expected += [pt_ds.SAMPLING_STREAM + epoch * spe + i + 1 for i in range(spe)]
        expected += [pt_ds.SAMPLING_STREAM + 2 ** 20 + epoch] * n_valid
    assert len(record['draws']) == len(expected)
    for got, stream in zip(record['draws'], expected):
        want = torch.rand(shape, generator=trainer._generator(stream))
        torch.testing.assert_close(got[:, :shape[1]], want[:got.shape[0]], rtol=0, atol=0)
    train_draws = [d for d, s in zip(record['draws'], expected) if s < pt_ds.SAMPLING_STREAM
                   + 2 ** 20]
    assert not torch.equal(train_draws[0], train_draws[1])
    assert record['snaps'] == 2 * (spe + n_valid)

    metrics = eval_metrics(model, None, trainer.datawrapper, 'validation')
    assert np.isfinite(metrics['full_loss']) and metrics['segm_loss'] > 0
    assert 'panel_shape_l2' in metrics
    predict = make_predict_fn(model, device_sampler=pt_ds.maybe_batch_sampler(
        trainer.datawrapper.dataset.config))
    batch = next(iter(trainer.datawrapper.loaders.validation))
    preds = predict(batch['features'])
    assert preds['outlines'].shape[0] == batch['ground_truth']['outlines'].shape[0]
    assert np.isfinite(preds['outlines']).all()
    with pytest.raises(ValueError, match='device_sampler'):
        make_predict_fn(model)(batch['features'])


def test_snap_runs_only_where_labels_are_read(synthetic_dataset_root, tmp_path, monkeypatch):
    """att.yaml's loss has no segmentation term: fit (its steps, validation
    and image logging), eval_metrics and the serving path draw clouds but
    never snap, as the JAX package's jit drops the unread snap."""
    trainer, model, exp, record = _fit(synthetic_dataset_root, tmp_path, LOSS, monkeypatch)
    trainer.log_with_visualization = True
    trainer.folder_for_preds = tmp_path / 'preds'
    trainer.folder_for_preds.mkdir()
    trainer._log_an_image(model, 0, 0)
    eval_metrics(model, None, trainer.datawrapper, 'validation')
    predict = make_predict_fn(model, device_sampler=trainer.device_sampler)
    batch = next(iter(trainer.datawrapper.loaders.validation))
    assert np.isfinite(predict(batch['features'])['outlines']).all()
    assert len(record['draws']) > trainer.step_count and record['snaps'] == 0
