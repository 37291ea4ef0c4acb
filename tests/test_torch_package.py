"""Rules of the port package that hold on any machine: it imports neither
JAX nor the JAX package, and its entry points do not drift to the CPU."""
import ast
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
    model = build_model('GarmentSegmentPattern3D', _DATA, _NN, device='cpu')
    assert model.loss is None and not model.module.training
    assert model.config['local_attention'] is True
    assert model.config['EConv_feature'] == 20
    x = torch.randn(2, 40, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        preds = model(x)
    assert preds['outlines'].shape == (2, 3, 4, 4)
    assert preds['att_weights'].shape == (2, 40, 3)
    torch.testing.assert_close(preds['att_weights'].sum(-1), torch.ones(2, 40))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        build_model('GarmentFullPattern3D', _DATA, _NN, device='cpu')
    with pytest.raises(NotImplementedError):
        build_model('GarmentSegmentPattern3D', _DATA,
                    dict(_NN, compute_dtype='bfloat16'), device='cpu')
    with pytest.raises(ValueError):
        build_model('NoSuchModel', _DATA, _NN, device='cpu')
    model = build_model('GarmentSegmentPattern3D', _DATA, _NN, device='cpu')
    model.module.train()
    with pytest.raises(NotImplementedError, match='train mode'):
        model(torch.zeros(1, 16, 3))
