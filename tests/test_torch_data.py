"""The port's copies of the host-side data pipeline against the JAX
package's: synthetic generation, mesh sampling and snapping, the pattern
codec, the dataset's samples, standardization, splits and balanced batches.

Every module compared here is numpy inside on both sides, so samples,
splits and batch orders must be equal exactly; the standardization
statistics are f64 sums cast to f32 on both sides (held within 1e-6).
Only `default_collate` differs by design: the port's hands a batch over as
torch CPU tensors of the same values.
"""
import filecmp
import json

import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch import core as pt_core
from garment_pattern_estimation_torch import data as pt_data
from garment_pattern_estimation_torch.preprocess import mesh as pt_mesh
from garment_pattern_estimation_torch.preprocess import native as pt_native
from garment_pattern_estimation_torch.utils import synthetic as pt_synthetic
from garment_pattern_estimation_tpu import core as jx_core
from garment_pattern_estimation_tpu import data as jx_data
from garment_pattern_estimation_tpu.preprocess import mesh as jx_mesh
from garment_pattern_estimation_tpu.utils import synthetic as jx_synthetic

FOLDERS = ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300']
SPLIT = {'valid_per_type': 1, 'test_per_type': 1, 'type': 'count', 'random_seed': 10}


def _config(root, **extra):
    return {'data_folders': FOLDERS, 'mesh_samples': 200,
            'panel_classification': str(root / 'panel_classes.json'), **extra}


@pytest.fixture(scope='module')
def datasets(synthetic_dataset_root):
    root = synthetic_dataset_root
    return (jx_data.Garment3DPatternFullDataset(root, _config(root)),
            pt_data.Garment3DPatternFullDataset(root, _config(root)))


@pytest.fixture(scope='module')
def wrappers(synthetic_dataset_root):
    """A DatasetWrapper on each side, split, batched (4) and standardized."""
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


def _assert_same_tree(ours, theirs, path=''):
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), path
        for key in theirs:
            _assert_same_tree(ours[key], theirs[key], f'{path}.{key}')
    elif isinstance(theirs, str):
        assert ours == theirs, path
    else:
        ours, theirs = np.asarray(ours), np.asarray(theirs)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        np.testing.assert_array_equal(ours, theirs, err_msg=path)


def test_generate_dataset_writes_equal_files(tmp_path):
    """The same seed writes the same files, byte for byte."""
    jx_root, pt_root = tmp_path / 'jax', tmp_path / 'port'
    jx_synthetic.generate_dataset(jx_root, samples_per_folder=6, seed=7)
    pt_synthetic.generate_dataset(pt_root, samples_per_folder=6, seed=7)
    jx_synthetic.panel_classes_for_templates(jx_root / 'panel_classes.json')
    pt_synthetic.panel_classes_for_templates(pt_root / 'panel_classes.json')
    files = sorted(p.relative_to(jx_root) for p in jx_root.rglob('*') if p.is_file())
    assert files == sorted(p.relative_to(pt_root) for p in pt_root.rglob('*') if p.is_file())
    assert len(files) > 3 * 6 * 3
    _, mismatch, errors = filecmp.cmpfiles(jx_root, pt_root, [str(f) for f in files],
                                           shallow=False)
    assert not mismatch and not errors


def test_mesh_sampling_and_snap_match(synthetic_dataset_root):
    """OBJ parsing, seeded surface sampling and the nearest-vertex snap of
    the two native builds agree exactly; the port's library lives in its
    own build directory."""
    assert pt_native.get_lib() is not None
    assert pt_native._library_path().parent.name == '_build'
    obj = sorted(synthetic_dataset_root.glob('*/*/*_sim.obj'))[0]
    verts, faces = pt_mesh.read_triangle_mesh(str(obj))
    jx_verts, jx_faces = jx_mesh.read_triangle_mesh(str(obj))
    np.testing.assert_array_equal(verts, jx_verts)
    np.testing.assert_array_equal(faces, jx_faces)
    points = pt_mesh.sample_mesh_points(500, verts, faces, seed=1234)
    np.testing.assert_array_equal(points, jx_mesh.sample_mesh_points(500, verts, faces,
                                                                     seed=1234))
    for ours, theirs in zip(pt_mesh.snap_points(points, verts),
                            jx_mesh.snap_points(points, verts)):
        np.testing.assert_array_equal(ours, theirs)


def test_pattern_codec_round_trip_matches(synthetic_dataset_root):
    """spec -> padded tensors -> spec -> tensors, on both sides: equal
    tensors at every stage and equal specs."""
    spec = sorted(synthetic_dataset_root.glob('*/*/specification.json'))[0]
    classes = str(synthetic_dataset_root / 'panel_classes.json')
    props = json.loads((spec.parent.parent / 'dataset_properties.json').read_text())
    template = props['templates'].split('/')[-1].split('.')[0]
    sides = []
    for core in (jx_core, pt_core):
        pattern = core.NNSewingPattern(spec, panel_classifier=core.PanelClasses(classes),
                                       template_name=template)
        tensors = pattern.pattern_as_tensors(with_placement=True, with_stitches=True,
                                             with_stitch_tags=True)
        rebuilt = core.NNSewingPattern(view_ids=False)
        rebuilt.name = 'rebuilt'
        rebuilt.pattern_from_tensors(tensors[0], panel_rotations=tensors[3],
                                     panel_translations=tensors[4], stitches=tensors[5],
                                     padded=True)
        again = rebuilt.pattern_as_tensors(with_placement=True, with_stitches=True)
        sides.append((tensors, again, json.dumps(rebuilt.spec, sort_keys=True, default=str)))
    (jx_tensors, jx_again, jx_spec), (pt_tensors, pt_again, pt_spec) = sides
    for ours, theirs in zip(pt_tensors + pt_again, jx_tensors + jx_again):
        _assert_same_tree(ours, theirs)
    assert pt_spec == jx_spec


def test_dataset_samples_match(datasets):
    """Every sample's features and ground truth are the JAX dataset's,
    dtypes included, and the inferred sizes agree."""
    jx_ds, pt_ds = datasets
    assert pt_ds.datapoints_names == jx_ds.datapoints_names
    for key in ('max_pattern_len', 'max_panel_len', 'max_num_stitches', 'element_size',
                'rotation_size', 'translation_size', 'stitch_tag_size', 'feature_size'):
        assert pt_ds.config[key] == jx_ds.config[key], key
    for i in range(len(jx_ds)):
        _assert_same_tree(pt_ds[i], jx_ds[i], path=jx_ds.datapoints_names[i])


def test_standardization_and_splits_match(wrappers):
    """Split index lists, per folder too, and the standardization statistics
    from the training split; standardized samples then agree exactly."""
    jx_w, pt_w = wrappers
    for section in ('training', 'validation', 'test'):
        assert getattr(pt_w, section).indices == getattr(jx_w, section).indices, section
    for section in ('training_per_datafolder', 'validation_per_datafolder',
                    'test_per_datafolder'):
        ours, theirs = getattr(pt_w, section), getattr(jx_w, section)
        assert sorted(ours) == sorted(theirs)
        assert all(ours[k].indices == theirs[k].indices for k in theirs), section
    ours, theirs = pt_w.dataset.config['standardize'], jx_w.dataset.config['standardize']
    for group in ('f_shift', 'f_scale'):
        np.testing.assert_allclose(ours[group], theirs[group], rtol=0, atol=1e-6)
    for group in ('gt_shift', 'gt_scale'):
        for key in theirs[group]:
            np.testing.assert_allclose(ours[group][key], theirs[group][key], rtol=0,
                                       atol=1e-6, err_msg=f'{group}.{key}')
    _assert_same_tree(pt_w.training[0], jx_w.training[0])


def test_balanced_batches_match_over_two_epochs(wrappers):
    """The seeded balanced sampler yields the same batches in the same
    order, epoch after epoch; the port's loader collates them into torch
    CPU tensors holding the JAX batch's values."""
    jx_w, pt_w = wrappers
    assert len(pt_w.loaders.train) == len(jx_w.loaders.train) > 0
    for _ in range(2):
        assert list(pt_w.loaders.train.batch_sampler) == list(jx_w.loaders.train.batch_sampler)
    for ours, theirs in zip(pt_w.loaders.validation, jx_w.loaders.validation):
        assert isinstance(ours['features'], torch.Tensor)
        assert ours['features'].device.type == 'cpu'
        np.testing.assert_array_equal(ours['features'].numpy(), theirs['features'])
        for key, value in theirs['ground_truth'].items():
            np.testing.assert_array_equal(ours['ground_truth'][key].numpy(), value)
        assert ours['name'] == theirs['name']


def test_on_device_sampling_raises(synthetic_dataset_root):
    root = synthetic_dataset_root
    with pytest.raises(NotImplementedError, match='on_device_sampling'):
        pt_data.Garment3DPatternFullDataset(root, _config(root, on_device_sampling=True))
