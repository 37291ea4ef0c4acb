"""Image logging of the port against the JAX package: `core/render.py`, the
render in `PatternSpec.serialize`, and `Trainer.fit(with_visualization)`,
whose `_log_an_image` saves one predicted pattern per data folder after
every epoch into the run's `intermediate_preds/` and logs each image as
'pred_img::<file name>'.

Both fits train the attention model at tests/test_torch_fit.py's tiny widths
from the same weights on one synthetic root (the JAX side on its plain
path). What is compared is exact: file names, the logged keys per epoch,
and the predicted patterns' panel names; renders are not compared pixel
for pixel (two processes' matplotlib state may differ).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch import data as pt_data
from garment_pattern_estimation_torch import experiment as pt_experiment
from garment_pattern_estimation_torch import train as pt_train
from garment_pattern_estimation_torch.cli.common import load_yaml
from garment_pattern_estimation_torch.core import PatternSpec as PtPatternSpec
from garment_pattern_estimation_torch.core import render as pt_render
from garment_pattern_estimation_torch.models import build_model as pt_build_model
from garment_pattern_estimation_torch.models.flax_import import state_dict_from_flax
from garment_pattern_estimation_tpu import data as jx_data
from garment_pattern_estimation_tpu import experiment as jx_experiment
from garment_pattern_estimation_tpu import train as jx_train
from garment_pattern_estimation_tpu.core import PatternSpec as JxPatternSpec
from garment_pattern_estimation_tpu.core import render as jx_render
from garment_pattern_estimation_tpu.models import build_model as jx_build_model
from test_torch_fit import LOSS, NN, SPLIT, _dataset

SETUP = {'batch_size': 4, 'epochs': 2, 'random_seed': 16, 'learning_rate': 2e-3,
         'optimizer': 'Adam', 'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'},
         'early_stopping': {'window': 1e-12, 'patience': 50}}
CONFIGS = Path(__file__).resolve().parents[1] / 'configs'
SHAPE_CONFIGS = ['att.yaml', 'att_bf16.yaml', 'lstm_stitch_tags.yaml']


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob('*') if p.is_file())


def _spec_file(root):
    return sorted(root.glob('tee_synth_300/*/specification.json'))[0]


def test_render_writes_the_same_files(synthetic_dataset_root, tmp_path):
    """`render_pattern` of both packages on one spec: PNG and SVG of the
    same names, each a non-empty file of its format."""
    spec = _spec_file(synthetic_dataset_root)
    for name, spec_class, render in (('jax', JxPatternSpec, jx_render),
                                     ('port', PtPatternSpec, pt_render)):
        pattern = spec_class(spec)
        (tmp_path / name).mkdir()
        for suffix in ('png', 'svg'):
            out = render.render_pattern(pattern, tmp_path / name / f'{pattern.name}.{suffix}')
            assert out == str(tmp_path / name / f'{pattern.name}.{suffix}')
    assert _tree(tmp_path / 'jax') == _tree(tmp_path / 'port')
    assert (tmp_path / 'port' / f'{PtPatternSpec(spec).name}.png').read_bytes()[:4] \
        == b'\x89PNG'
    assert b'<svg' in (tmp_path / 'port' / f'{PtPatternSpec(spec).name}.svg').read_bytes()


def test_serialize_renders_like_jax(synthetic_dataset_root, tmp_path):
    """`serialize` writes the spec, then `<name><tag>_pattern.png/.svg`, as
    the JAX package's does; the specs are equal."""
    spec = _spec_file(synthetic_dataset_root)
    jx_dir = JxPatternSpec(spec).serialize(tmp_path / 'jax', tag='_t')
    pt_dir = PtPatternSpec(spec).serialize(tmp_path / 'port', tag='_t')
    assert _tree(tmp_path / 'jax') == _tree(tmp_path / 'port')
    assert len(_tree(tmp_path / 'port')) == 3
    name = PtPatternSpec(spec).name
    assert json.loads((tmp_path / 'port' / name / f'{name}_t_specification.json').read_text()) \
        == json.loads((tmp_path / 'jax' / name / f'{name}_t_specification.json').read_text())
    assert pt_dir.endswith(name) and jx_dir.endswith(name)


def test_failed_render_only_warns(synthetic_dataset_root, tmp_path, monkeypatch, capsys):
    """A render that raises (as a missing matplotlib does) leaves the spec
    written and prints a warning."""
    def broken(*args, **kwargs):
        raise ImportError('No module named matplotlib')

    monkeypatch.setattr(pt_render, 'render_pattern', broken)
    monkeypatch.setattr('garment_pattern_estimation_torch.core.pattern_spec._render_warned',
                        False)
    pattern = PtPatternSpec(_spec_file(synthetic_dataset_root))
    pattern.serialize(tmp_path)
    assert _tree(tmp_path) == [f'{pattern.name}/{pattern.name}_specification.json']
    assert 'failed to render' in capsys.readouterr().out


def _fit_jax(root, out, variables=None):
    dataset = _dataset(jx_data, root)
    exp = jx_experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'viz', 'run_name': 'jax'}}, output_root=out)
    trainer = jx_train.Trainer(dict(SETUP, mesh={'data': 1}), exp, dataset, dict(SPLIT),
                               with_norm=True, with_visualization=True)
    trainer.init_randomizer()
    model = jx_build_model('GarmentSegmentPattern3D', dataset.config, NN, LOSS,
                           use_pallas=False)
    if variables is None:
        import jax
        sample = next(iter(trainer.datawrapper.loaders.validation))
        variables = model.init_variables(jax.random.PRNGKey(3),
                                         np.asarray(sample['features'][:2]))
        variables = jax.tree_util.tree_map(np.array, variables)
    trainer.fit(model, variables)
    return exp, variables


def _fit_port(root, out, state):
    dataset = _dataset(pt_data, root)
    exp = pt_experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'viz', 'run_name': 'port'}}, output_root=out)
    trainer = pt_train.Trainer(SETUP, exp, dataset, dict(SPLIT), with_norm=True,
                               with_visualization=True, device='cpu')
    trainer.init_randomizer()
    model = pt_build_model('GarmentSegmentPattern3D', dataset.config, NN, LOSS, device='cpu')
    trainer.fit(model, state)
    return exp, trainer, model


def _image_records(experiment):
    records = [json.loads(line) for line in
               (experiment.run_dir() / 'metrics.jsonl').read_text().splitlines()]
    return [(r['epoch'], r['step'], key) for r in records for key in r
            if key.startswith('pred_img::')]


@pytest.fixture(scope='module')
def fits(synthetic_dataset_root, tmp_path_factory):
    torch.set_num_threads(1)
    root, out = synthetic_dataset_root, tmp_path_factory.mktemp('viz')
    jx_exp, variables = _fit_jax(root, out / 'jax')
    pt_exp, trainer, model = _fit_port(root, out / 'port', state_dict_from_flax(variables))
    return {'jax': jx_exp, 'port': pt_exp, 'trainer': trainer, 'model': model}


def test_intermediate_preds_tree_matches_jax(fits):
    """The same files under intermediate_preds/: per data folder one
    garment, its predicted spec, PNG, SVG, attention weights and GT copies."""
    ours = _tree(fits['port'].run_dir() / 'intermediate_preds')
    theirs = _tree(fits['jax'].run_dir() / 'intermediate_preds')
    assert ours == theirs
    assert sum(p.endswith('_predicted__pattern.png') for p in ours) == 3
    assert sum(p.endswith('_predicted__pattern.svg') for p in ours) == 3


def test_logged_image_keys_match_jax(fits):
    """The same 'pred_img::<file>' keys at the same epochs and log steps."""
    ours, theirs = _image_records(fits['port']), _image_records(fits['jax'])
    assert ours == theirs
    assert sorted({epoch for epoch, _, _ in ours}) == [0, 1]
    assert len(ours) == 2 * 3


def test_predicted_patterns_match_jax(fits):
    """The last epoch's predicted specs name the same panels."""
    root = {k: fits[k].run_dir() / 'intermediate_preds' for k in ('jax', 'port')}
    for spec in sorted(root['port'].rglob('*_predicted__specification.json')):
        theirs = root['jax'] / spec.relative_to(root['port'])
        assert sorted(json.loads(spec.read_text())['pattern']['panels']) \
            == sorted(json.loads(theirs.read_text())['pattern']['panels'])


def test_returned_png_paths_exist(fits, tmp_path):
    """Every image path `save_prediction_batch` returns is a file."""
    trainer, model = fits['trainer'], fits['model']
    batch = next(iter(trainer.datawrapper.loaders.valid_single_per_data))
    with torch.no_grad():
        preds = {k: v.numpy() for k, v in model.module.eval()(batch['features']).items()}
    paths = trainer.datawrapper.dataset.save_prediction_batch(
        preds, batch['name'], batch['data_folder'], save_to=tmp_path)
    assert len(paths) == len(batch['name']) == 3
    assert all(p.is_file() and p.suffix == '.png' for p in paths)


def test_a_failing_forward_is_not_swallowed(fits, monkeypatch):
    """A fault in `_log_an_image`'s eval forward (the fused kernel on the
    card) propagates, unlike the JAX trainer's catch-all."""
    trainer, model = fits['trainer'], fits['model']

    def faulty(*args, **kwargs):
        raise RuntimeError('fused_edgeconv: kernel launch failed with CUDA error 700')

    monkeypatch.setattr('garment_pattern_estimation_torch.models.blocks.fused_edgeconv', faulty)
    with pytest.raises(RuntimeError, match='CUDA error 700'):
        trainer._log_an_image(model, 0, 0)


@pytest.mark.parametrize('config', SHAPE_CONFIGS)
def test_shipped_configs_build_a_trainer(config):
    """The shipped shape configs set `with_visualization: true`; the port's
    Trainer takes their trainer section as the train CLI passes it."""
    section = load_yaml(CONFIGS / config)['trainer']
    assert section['with_visualization'] is True
    trainer = pt_train.Trainer(section, with_visualization=section['with_visualization'],
                               device='cpu')
    assert trainer.log_with_visualization
