"""The port's serving artifact against its eager pipeline and the JAX
package's artifact: the fused EdgeConv as a registered operator
(`gpe_torch::fused_edgeconv`, checked by `torch.library.opcheck`),
`export_serving_artifact` -> `load_serving_artifact` equal to
`build_serving_fn` to 0.0 on the CPU (the exported graph runs the same
operators on the same inputs), the manifest's keys equal to the JAX
manifest's, input checks, and the `export_serving` CLI of both packages on
one run.
"""
import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch.cli import export_serving as pt_export_cli
from garment_pattern_estimation_torch.experiment import (build_serving_fn,
                                                         export_serving_artifact,
                                                         load_serving_artifact)
from garment_pattern_estimation_torch.models import build_model
from garment_pattern_estimation_torch.ops import edgeconv
from garment_pattern_estimation_tpu.cli import export_serving as jx_export_cli
from test_serving import DATA_CONFIG as JAX_DATA
from test_serving import NN_CONFIG as JAX_NN
from test_torch_edgeconv import _synthetic_mlp, _torch_fold
from test_torch_evaluation import env  # noqa: F401  (the shape run of both packages)
from test_torch_full_model import SMALL as FULL_SMALL
from test_torch_full_model import NN as FULL_NN
from test_torch_model import NN
from test_torch_serving import SERVE_DATA

torch.set_num_threads(1)

B, N = 2, 96
VARIANTS = {
    'att_f32': ('GarmentSegmentPattern3D', NN),
    'att_bf16': ('GarmentSegmentPattern3D', dict(NN, compute_dtype='bfloat16')),
    'baseline': ('GarmentFullPattern3D', dict(FULL_NN, **FULL_SMALL)),
}


@pytest.mark.parametrize('C,widths,k,bf16,return_idx', [
    (3, [(6, 8), (8, 8)], 5, False, False),
    (3, [(6, 8), (8, 8)], 5, False, True),
    (24, [(48, 16), (16, 12)], 4, True, True),
    (24, [(48, 16), (16, 12)], 4, True, False),
])
def test_operator_opcheck(rng, C, widths, k, bf16, return_idx):
    """Schema, fake (shape) implementation, dispatch and autograd
    registration of the operator agree with its CPU implementation."""
    layers, (a, d) = _torch_fold(_synthetic_mlp(rng, widths))
    x = torch.from_numpy(rng.normal(size=(2, 40, C)).astype(np.float32))
    args = (x, [w for w, _ in layers], [b for _, b in layers], a, d, k, bf16, 0, return_idx)
    torch.library.opcheck(edgeconv.fused_edgeconv_op, args)
    out, idx = edgeconv.fused_edgeconv_op(*args)
    ref, ref_idx = edgeconv.fused_edgeconv_reference(
        x, (layers, (a, d)), k, torch.bfloat16 if bf16 else torch.float32, return_idx=True)
    assert torch.equal(out, ref)
    assert torch.equal(idx, ref_idx) if return_idx else idx.shape == (0,)


@pytest.fixture(scope='module', params=sorted(VARIANTS))
def exported(request, tmp_path_factory):
    name, nn_config = VARIANTS[request.param]
    model = build_model(name, SERVE_DATA, nn_config, device='cpu', seed=2)
    out = tmp_path_factory.mktemp(request.param)
    manifest = export_serving_artifact(model, SERVE_DATA, out, batch_size=B, num_points=N)
    return model, out, manifest


def test_reloaded_artifact_equals_serving_fn(exported):
    model, out, manifest = exported
    points = np.random.default_rng(3).normal(size=(B, N, 3)).astype(np.float32) * 10.0
    ref = build_serving_fn(model, SERVE_DATA)(points)
    served = load_serving_artifact(out)(points)
    assert sorted(served) == sorted(ref) == sorted(manifest['outputs'])
    for key in ref:
        assert torch.equal(served[key], ref[key]), key
        assert list(served[key].shape) == manifest['outputs'][key]['shape']
        assert str(served[key].dtype) == 'torch.' + manifest['outputs'][key]['dtype']


def test_exported_graph_calls_the_operator(exported):
    """Each EdgeConv layer is one call of the registered operator."""
    _, out, _ = exported
    program = torch.export.load(out / 'model.pt2')
    calls = [n for n in program.graph.nodes
             if n.op == 'call_function' and 'gpe_torch.fused_edgeconv' in str(n.target)]
    assert len(calls) == 2


def test_input_checks(exported):
    _, out, manifest = exported
    served = load_serving_artifact(out / 'model.pt2')
    assert served.platforms == ('cpu',) and manifest['platforms'] == ['cpu']
    with pytest.raises(ValueError, match='input shape'):
        served(np.zeros((B + 1, N, 3), np.float32))
    with pytest.raises(ValueError, match='exported for'):
        served(torch.zeros(B, N, 3, device='meta'))


def test_manifest_keys_match_jax(exported, tmp_path):
    """The same top-level keys as the JAX package's manifest, and the same
    output keys for the same model family."""
    import jax
    from garment_pattern_estimation_tpu.experiment.serving import (
        export_serving_artifact as jx_export)
    from garment_pattern_estimation_tpu.models import build_model as jx_build_model

    model, out, manifest = exported
    jx_model = jx_build_model(model.name, JAX_DATA, JAX_NN, use_pallas=False)
    variables = jx_model.init_variables(jax.random.PRNGKey(0), np.zeros((B, 40, 3), np.float32))
    theirs = jx_export(jx_model, variables, JAX_DATA, tmp_path, batch_size=B, num_points=40)
    assert sorted(manifest) == sorted(theirs)
    assert sorted(manifest['outputs']) == sorted(theirs['outputs'])
    assert manifest['input'] == dict(theirs['input'], shape=[B, N, 3])
    assert manifest['blob_bytes'] == (out / 'model.pt2').stat().st_size


@pytest.mark.parametrize('bf16', [False, True])
def test_export_serving_cli(env, tmp_path, bf16):  # noqa: F811
    """Both packages' CLIs export the same run (its reference `.pth`
    through the pre-trained fallback): the same manifest keys and extra
    metadata; the port's artifact equals its eager pipeline."""
    manifests = {}
    extra = ['--bf16'] if bf16 else []
    for package, cli, device in (('jax', jx_export_cli, ['--platforms', 'cpu']),
                                 ('port', pt_export_cli, ['--device', 'cpu'])):
        manifests[package] = cli.main(
            ['-c', str(env['configs']['shape']), '-o', str(tmp_path / package), '-b', '2',
             '--system', str(env['systems'][package])] + device + extra)
    ours, theirs = manifests['port'], manifests['jax']
    assert sorted(ours) == sorted(theirs)
    for key in ('checkpoint_alias', 'compute_dtype', 'input', 'model'):
        assert ours[key] == theirs[key], key
    assert ours['experiment'] == theirs['experiment'] == 'eval/shape_shape'
    assert ours['compute_dtype'] == ('bfloat16' if bf16 else 'float32')

    exp = env['runs']['port']['shape']
    _, _, data_config = exp.data_info()
    model, _ = exp.load_model(data_config, device='cpu',
                              nn_overrides={'compute_dtype': 'bfloat16'} if bf16 else None)
    points = np.random.default_rng(8).normal(size=(2, 60, 3)).astype(np.float32)
    ref = build_serving_fn(model, data_config)(points)
    served = load_serving_artifact(tmp_path / 'port')(points)
    for key in ref:
        assert torch.equal(served[key], ref[key]), key
