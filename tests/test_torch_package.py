"""Rules of the port package that hold on any machine: it imports neither
JAX nor the JAX package, and its entry points do not drift to the CPU."""
import ast
import re
from pathlib import Path

import pytest
import torch

import garment_pattern_estimation_torch
from garment_pattern_estimation_torch import resolve_device
from garment_pattern_estimation_torch.models import build_model

_PACKAGE = Path(garment_pattern_estimation_torch.__file__).resolve().parent
_FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'garment_pattern_estimation_tpu')

_DATA = {'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
         'max_panel_len': 4, 'max_pattern_len': 3}
_NN = {'panel_encoding_size': 8, 'panel_n_layers': 1, 'EConv_hidden': 8,
       'EConv_feature': 20, 'k_neighbors': 3, 'skip_connections': True,
       'local_attention': True}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(_PACKAGE.rglob('*.py')),
                         ids=lambda p: str(p.relative_to(_PACKAGE)))
def test_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f'{path.name} imports {bad}'


def test_import_scan_covers_the_training_modules():
    scanned = {str(p.relative_to(_PACKAGE)) for p in _PACKAGE.rglob('*.py')}
    assert {'ops/knn_gather.py', 'ops/sparsemax.py', 'losses/components.py',
            'losses/composed.py', 'train/trainer.py', 'models/blocks.py',
            'ops/edgeconv_train.py', 'ops/knn.py'} <= scanned


def test_import_scan_covers_the_data_pipeline():
    """The port's own copies of the JAX package's host-side modules are
    scanned too."""
    scanned = {str(p.relative_to(_PACKAGE)) for p in _PACKAGE.rglob('*.py')}
    assert {'core/rotations.py', 'core/pattern_spec.py', 'core/pattern_codec.py',
            'core/panel_classes.py', 'core/properties.py', 'preprocess/native.py',
            'preprocess/mesh.py', 'losses/stitches.py', 'data/transforms.py',
            'data/sampler.py', 'data/loader.py', 'data/utils.py', 'data/datasets.py',
            'data/wrapper.py', 'utils/synthetic.py', 'experiment/checkpoint.py',
            'experiment/tracker.py'} <= scanned
    assert (_PACKAGE / 'preprocess' / '_native' / 'mesh_ops.cpp').exists()


def test_import_scan_covers_the_evaluation_modules():
    """The evaluation, prediction and export modules are scanned too, and
    importing the renderer needs no matplotlib."""
    scanned = {str(p.relative_to(_PACKAGE)) for p in _PACKAGE.rglob('*.py')}
    assert {'core/render.py', 'experiment/torch_import.py', 'experiment/serving.py',
            'cli/on_test_set.py', 'cli/predict_per_example.py', 'cli/noise_levels.py',
            'cli/export_serving.py'} <= scanned
    assert 'matplotlib' not in {
        node.names[0].name.split('.')[0] if isinstance(node, ast.Import) else node.module
        for node in ast.parse((_PACKAGE / 'core' / 'render.py').read_text()).body
        if isinstance(node, (ast.Import, ast.ImportFrom))}


def test_import_scan_covers_the_sampling_and_tool_modules():
    """The on-device sampling stage and the two host CLIs are scanned too,
    and importing the attention-weights CLI needs no matplotlib."""
    scanned = {str(p.relative_to(_PACKAGE)) for p in _PACKAGE.rglob('*.py')}
    assert {'preprocess/device_sampling.py', 'cli/att_weights_viz.py',
            'cli/utility_scripts.py'} <= scanned
    top_level = {node.names[0].name.split('.')[0] if isinstance(node, ast.Import)
                 else node.module
                 for node in ast.parse((_PACKAGE / 'cli' / 'att_weights_viz.py').read_text()).body
                 if isinstance(node, (ast.Import, ast.ImportFrom))}
    assert 'matplotlib' not in top_level


def test_import_scan_covers_the_comparator():
    """The parity CLI is scanned too: it reads a JAX report, never imports
    the JAX package."""
    scanned = {str(p.relative_to(_PACKAGE)) for p in _PACKAGE.rglob('*.py')}
    assert 'cli/parity_check.py' in scanned
    assert not set(_imported_roots(_PACKAGE / 'cli' / 'parity_check.py')) & set(_FORBIDDEN)


def test_import_scan_covers_the_parallel_modules():
    """The data-parallel and ring modules are scanned, and so is the rank
    module the spawned test processes import: the ranks never import JAX."""
    scanned = {str(p.relative_to(_PACKAGE)) for p in _PACKAGE.rglob('*.py')}
    assert {'parallel/__init__.py', 'parallel/mesh.py', 'parallel/collectives.py',
            'parallel/ring.py', 'parallel/dryrun.py'} <= scanned
    ranks = _PACKAGE.parent / 'tests' / 'torch_parallel_ranks.py'
    assert not set(_imported_roots(ranks)) & set(_FORBIDDEN)


# a path to a data file inside the JAX package
_JAX_DATA_FILE = re.compile(r'garment_pattern_estimation_tpu/[\w/.-]*\.'
                            r'(json|ya?ml|npz|npy|txt|csv|pth|pt|msgpack|obj)\b')


def _data_paths_into_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return sorted({node.value for node in ast.walk(tree)
                   if isinstance(node, ast.Constant) and isinstance(node.value, str)
                   and (_JAX_DATA_FILE.search(node.value)
                        or 'garment_pattern_estimation_tpu/data_configs' in node.value)})


@pytest.mark.parametrize('path', [*sorted(_PACKAGE.rglob('*.py')),
                                  _PACKAGE.parent / 'chip_smoke.py'],
                         ids=lambda p: p.name if p.parent == _PACKAGE.parent
                         else str(p.relative_to(_PACKAGE)))
def test_no_string_names_a_data_file_of_the_jax_package(path):
    """Fault C8: no string literal of the port's modules or chip_smoke.py
    names a file under garment_pattern_estimation_tpu/ (data_configs/ and
    any other data file): the port reads its own copies."""
    assert not _data_paths_into_the_jax_package(path)


def test_data_configs_are_the_jax_packages_copied():
    """The port's data_configs/ holds the five JSON files of the JAX
    package's, byte for byte, and the scan above catches a path into the
    JAX package's."""
    theirs = _PACKAGE.parent / 'garment_pattern_estimation_tpu' / 'data_configs'
    ours = _PACKAGE / 'data_configs'
    names = sorted(p.name for p in theirs.glob('*.json'))
    assert len(names) == 5 and sorted(p.name for p in ours.glob('*.json')) == names
    assert all((ours / n).read_bytes() == (theirs / n).read_bytes() for n in names)
    assert _JAX_DATA_FILE.search('./garment_pattern_estimation_tpu/data_configs/x.json')
    assert not _JAX_DATA_FILE.search('garment_pattern_estimation_tpu/train/trainer.py:46')


def test_resolve_device_under_a_process_group(monkeypatch, tmp_path):
    """Under a process group (torchrun) None and 'cuda' name this rank's
    card, cuda:LOCAL_RANK; an indexed card and the CPU stay as named. The
    card is faked: a world-1 gloo group on the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setenv('LOCAL_RANK', '3')
    assert resolve_device(None) == torch.device('cuda')            # no group yet
    dist.init_process_group('gloo', store=dist.FileStore(str(tmp_path / 'store'), 1),
                            rank=0, world_size=1)
    try:
        assert resolve_device(None) == resolve_device('cuda') == torch.device('cuda', 3)
        assert resolve_device('cuda:1') == torch.device('cuda', 1)
        assert resolve_device('cpu') == torch.device('cpu')
    finally:
        dist.destroy_process_group()


def test_chip_smoke_imports_no_jax():
    path = _PACKAGE.parent / 'chip_smoke.py'
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f'chip_smoke.py imports {bad}'


def test_build_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_model('GarmentSegmentPattern3D', _DATA, _NN)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')


def test_build_model_on_cpu_is_eval_and_lossless():
    """Built in eval mode; without a loss section the loss takes the
    registry's defaults, as the JAX registry's does."""
    model = build_model('GarmentSegmentPattern3D', _DATA, _NN, device='cpu')
    assert not model.module.training
    assert model.loss.config['loss_components'] == ['shape', 'loop', 'rotation', 'translation']
    assert model.config['loss'] is model.loss.config
    assert model.config['local_attention'] is True
    assert model.config['EConv_feature'] == 20
    x = torch.randn(2, 40, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        preds = model(x)
    assert preds['outlines'].shape == (2, 3, 4, 4)
    assert preds['att_weights'].shape == (2, 40, 3)
    torch.testing.assert_close(preds['att_weights'].sum(-1), torch.ones(2, 40))


def test_unported_options_raise():
    """The baseline builds (its pattern decoder, no attention head); the
    stitch model builds on the CPU with the registry's defaults and gives
    (B, P) logits; graph pooling builds (a pool after each conv layer) and
    raises ValueError with the xyz skip, as the JAX package does; LSTM
    dropout runs in train mode."""
    full = build_model('GarmentFullPattern3D', _DATA, _NN, device='cpu')
    assert {'pattern_decoder.lstm.weight_ih_l0', 'feature_extractor.lin.weight'} \
        <= set(full.module.state_dict())
    with torch.no_grad():
        assert full(torch.zeros(1, 16, 3))['outlines'].shape == (1, 3, 4, 4)
    stitch = build_model('StitchOnEdge3DPairs', {'element_size': 16}, {}, device='cpu')
    assert stitch.config['stitch_hidden_size'] == 200
    assert stitch.config['stitch_mlp_n_layers'] == 3
    assert stitch.loss.config['loss_components'] == ['edge_pair_class']
    assert not stitch.module.training
    with torch.no_grad():
        assert stitch(torch.randn(2, 7, 16)).shape == (2, 7)
    pooled = build_model('GarmentSegmentPattern3D', _DATA,
                         dict(_NN, graph_pooling=True, skip_connections=False), device='cpu')
    assert len(pooled.module.feature_extractor.pool_layers) == 2
    with torch.no_grad():
        assert pooled(torch.zeros(1, 16, 3))['att_weights'].shape == (1, 1, 3)
    with pytest.raises(ValueError, match='skip connections'):
        build_model('GarmentSegmentPattern3D', _DATA,
                    dict(_NN, graph_pooling=True), device='cpu')
    with pytest.raises(ValueError):
        build_model('NoSuchModel', _DATA, _NN, device='cpu')
    model = build_model('GarmentSegmentPattern3D', _DATA,
                        dict(_NN, panel_n_layers=2, dropout=0.1), device='cpu')
    model.module.train()
    assert torch.isfinite(model(torch.randn(2, 16, 3))['outlines']).all()


def test_att_bf16_config_builds_on_the_cpu():
    """configs/att_bf16.yaml's NN section builds unchanged: the bf16 mode
    reaches both conv layers and the attention MLP, parameters stay f32,
    the merged config records it, and the eval forward's outputs are f32.
    A compute dtype other than float32 and bfloat16 raises ValueError."""
    import yaml

    config = yaml.safe_load((_PACKAGE.parent / 'configs' / 'att_bf16.yaml').read_text())
    data = {k: config['dataset'][k] for k in ('element_size', 'rotation_size',
                                              'translation_size', 'max_panel_len',
                                              'max_pattern_len')}
    nn_section = config['NN']
    model = build_model(nn_section['model'], data, nn_section, nn_section['loss'],
                        device='cpu')
    assert model.config['compute_dtype'] == 'bfloat16'
    assert model.config['f32_conv_layers'] == [] and model.config['f32_attention_mlp'] is False
    module = model.module
    assert [c.compute_dtype for c in module.feature_extractor.conv_layers] == [torch.bfloat16] * 2
    assert module.point_segment_mlp[0].compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in module.parameters())
    x = torch.randn(1, 24, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        preds = model(x)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in preds.values())
    assert preds['outlines'].shape == (1, 23, 14, 4)
    with pytest.raises(ValueError, match='compute_dtype'):
        build_model('GarmentSegmentPattern3D', _DATA, dict(_NN, compute_dtype='float16'),
                    device='cpu')
