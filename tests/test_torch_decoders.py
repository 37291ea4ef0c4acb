"""The port's alternative decoders and the LSTM encoder against the JAX
package's modules, on the same weights and inputs from
`np.random.default_rng`, and `state_dict_from_flax` on every combination of
encoder and decoders the JAX registries accept.

Modules: `TorchGRU` and `GRUDecoderModule` (gate order r, z, n; its cell
named `recurrent_cell`), `LSTMDoubleReverseDecoderModule` (the forward LSTM
starts from the reverse pass's final states), `MLPDecoder` (eval with
perturbed running statistics, train with batch statistics and the running
averages' update) and `LSTMEncoderModule`. Initial states are zeros on both
sides, or the same numpy states injected into both (the JAX package draws
them from its own rng). Widths are small (hidden 16-32, 2 layers).

Tolerances: the recurrent modules are f32 cell loops on both sides, so
1e-5 of each output's largest magnitude; the MLP decoder's BatchNorm folds
and batch statistics sum in another order: 1e-5 as well (no bf16 rounding
anywhere on these paths), and its running statistics 1e-5 of each buffer's
largest magnitude.
"""
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import DATA_CONFIG, LOSS_CONFIG
from garment_pattern_estimation_tpu.models import blocks as jax_blocks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_torch.models import blocks, build_model, state_dict_from_flax
from garment_pattern_estimation_torch.models.flax_import import _lstm, _mlp

torch.set_num_threads(1)

B, T, ENC, HIDDEN, OUT, LAYERS = 3, 5, 12, 16, 7, 2


def assert_close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert np.abs(out - ref).max() <= rel * scale, (np.abs(out - ref).max(), scale)


def _init(module, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, variables)


def _states(rng, with_cell=True):
    """Nonzero initial states per layer, (B, HIDDEN) each, as numpy."""
    def draw():
        return rng.normal(size=(B, HIDDEN)).astype(np.float32) * 0.5
    return [(draw(), draw()) if with_cell else draw() for _ in range(LAYERS)]


def _inject(monkeypatch, states):
    """Both packages' decoders start from `states` (numpy, per layer)."""
    def jax_states(self, module, batch_size, n_layers, hidden, with_cell=True):
        assert (batch_size, n_layers, hidden) == (B, LAYERS, HIDDEN)
        return jax.tree_util.tree_map(jnp.asarray, states)

    def torch_states(self, batch_size, device, generator=None, with_cell=True):
        return jax.tree_util.tree_map(torch.from_numpy, states)

    monkeypatch.setattr(jax_blocks._StateInitMixin, '_init_states', jax_states)
    monkeypatch.setattr(blocks._Recurrent, 'initial_states', torch_states)


def _load_rnn(module, params):
    sd = {}
    _lstm(sd, 'cell', params)
    module.load_state_dict({k[len('cell.'):]: v for k, v in sd.items()})


def _load_decoder(module, params, stats=None):
    sd = {}
    for flax_name, ours in (('lstm', 'lstm'), ('lstm_reverse', 'lstm_reverse'),
                            ('lstm_forward', 'lstm_forward'), ('gru', 'recurrent_cell')):
        if flax_name in params:
            _lstm(sd, ours, params[flax_name])
    if 'MLP_0' in params:
        _mlp(sd, 'mlp', params['MLP_0'], stats['MLP_0'])
    if 'lin' in params:
        sd['lin.weight'] = torch.from_numpy(params['lin']['kernel'].T.copy())
        sd['lin.bias'] = torch.from_numpy(params['lin']['bias'].copy())
    module.load_state_dict(sd)


@pytest.fixture()
def rng():
    return np.random.default_rng(12)


def test_torch_gru_matches_jax(rng):
    """The cell loop with nonzero initial states: every output step."""
    x = rng.normal(size=(B, T, ENC)).astype(np.float32)
    states = _states(rng, with_cell=False)
    ref_module = jax_blocks.TorchGRU(HIDDEN, LAYERS)
    variables = _init(ref_module, jnp.asarray(x), [jnp.asarray(h) for h in states])
    ref = ref_module.apply(variables, jnp.asarray(x), [jnp.asarray(h) for h in states])
    gru = blocks.TorchGRU(ENC, HIDDEN, LAYERS)
    _load_rnn(gru, variables['params'])
    with torch.no_grad():
        out = gru(torch.from_numpy(x), [torch.from_numpy(h) for h in states])
    assert_close(out.numpy(), ref)


@pytest.mark.parametrize('name', ['GRUDecoderModule', 'LSTMDoubleReverseDecoderModule',
                                  'LSTMDecoderModule'])
@pytest.mark.parametrize('injected', [False, True])
def test_recurrent_decoder_matches_jax(rng, monkeypatch, name, injected):
    """Zero states (no rng, no generator) or the same nonzero states on both
    sides: the double-reverse decoder's forward pass then starts from
    nonzero final states of its reverse pass."""
    enc = rng.normal(size=(B, ENC)).astype(np.float32)
    if injected:
        _inject(monkeypatch, _states(rng, with_cell=name != 'GRUDecoderModule'))
    kwargs = dict(hidden_size=HIDDEN, out_elem_size=OUT, n_layers=LAYERS, out_len=T)
    ref_module = getattr(jax_blocks, name)(encoding_size=ENC, **kwargs)
    variables = _init(ref_module, jnp.asarray(enc))
    ref = ref_module.apply(variables, jnp.asarray(enc))
    decoder = blocks.DECODER_REGISTRY[name](encoding_size=ENC, **kwargs)
    _load_decoder(decoder, variables['params'])
    with torch.no_grad():
        out = decoder(torch.from_numpy(enc))
    assert out.shape == (B, T, OUT)
    assert_close(out.numpy(), ref)
    if name == 'GRUDecoderModule':
        assert {n.split('.')[0] for n, _ in decoder.named_parameters()} \
            == {'recurrent_cell', 'lin'}


def test_gru_states_from_a_generator():
    """The GRU decoder draws h only, one (B, H) state per layer, std
    sqrt(2 / (B H)) as the LSTM decoders draw them; zeros without a
    generator; a new draw per forward."""
    decoder = blocks.GRUDecoderModule(ENC, HIDDEN, OUT, LAYERS, T)
    gen = torch.Generator().manual_seed(3)
    states = decoder.initial_states(64, 'cpu', gen, with_cell=False)
    assert len(states) == LAYERS and all(s.shape == (64, HIDDEN) for s in states)
    np.testing.assert_allclose(torch.stack(states).std().item(),
                               (2.0 / (64 * HIDDEN)) ** 0.5, rtol=0.1)
    assert not any(s.any() for s in decoder.initial_states(64, 'cpu', None, with_cell=False))
    enc = torch.randn(2, ENC, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        first, second = decoder(enc, generator=gen), decoder(enc, generator=gen)
        zeros = decoder(enc)
    assert not torch.equal(first, second) and not torch.equal(first, zeros)


@pytest.mark.parametrize('train', [False, True])
def test_mlp_decoder_matches_jax(rng, train):
    """Eval with perturbed running statistics folded in; train with the
    batch statistics over the B rows and the running averages' update."""
    enc = rng.normal(size=(8, ENC)).astype(np.float32)
    ref_module = jax_blocks.MLPDecoder(encoding_size=ENC, hidden_size=3, out_elem_size=OUT,
                                       n_layers=LAYERS, out_len=T)
    variables = _init(ref_module, jnp.asarray(enc))
    stats = jax.tree_util.tree_map(
        lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(np.float32),
        variables['batch_stats'])
    variables = {'params': variables['params'], 'batch_stats': stats}
    decoder = blocks.MLPDecoder(ENC, 3, OUT, LAYERS, T)
    _load_decoder(decoder, variables['params'], variables['batch_stats'])
    assert [layer[0].out_features for layer in decoder.mlp] == [3 * T, 3 * T, OUT * T]
    if train:
        ref, mutated = ref_module.apply(variables, jnp.asarray(enc), train=True,
                                        mutable=['batch_stats'])
        decoder.train()
    else:
        ref = ref_module.apply(variables, jnp.asarray(enc))
        decoder.eval()
    with torch.set_grad_enabled(train):
        out = decoder(torch.from_numpy(enc))
    assert out.shape == (8, T, OUT)
    assert_close(out.detach().numpy(), ref)
    if train:
        for j, layer in enumerate(decoder.mlp):
            bn = mutated['batch_stats']['MLP_0'][f'BatchNorm_{j}']
            assert_close(layer[2].running_mean.numpy(), bn['mean'])
            assert_close(layer[2].running_var.numpy(), bn['var'])
    with pytest.raises(ValueError, match='out_len'):
        decoder(torch.from_numpy(enc), out_len=T + 1)


def test_lstm_encoder_matches_jax(rng, monkeypatch):
    """The last layer's final hidden state, from zero and injected states."""
    seq = rng.normal(size=(B, T, ENC)).astype(np.float32)
    ref_module = jax_blocks.LSTMEncoderModule(encoding_size=HIDDEN, n_layers=LAYERS)
    variables = _init(ref_module, jnp.asarray(seq))
    encoder = blocks.LSTMEncoderModule(ENC, HIDDEN, LAYERS)
    sd = {}
    _lstm(sd, 'lstm', variables['params']['lstm'])
    encoder.load_state_dict(sd)
    for inject in (False, True):
        if inject:
            _inject(monkeypatch, _states(rng))
        ref = ref_module.apply(variables, jnp.asarray(seq))
        with torch.no_grad():
            out = encoder(torch.from_numpy(seq))
        assert out.shape == (B, HIDDEN)
        assert_close(out.numpy(), ref)


# ---- state_dict_from_flax on every combination of the registries ----

ENCODERS = {'EdgeConvFeatures': {},
            'graph_pooling': {'graph_pooling': True, 'skip_connections': False},
            'EdgeConvPoolingFeatures': {'feature_extractor': 'EdgeConvPoolingFeatures'},
            'PointNetPlusPlus': {'feature_extractor': 'PointNetPlusPlus'}}
DECODERS = sorted(blocks.DECODER_REGISTRY)
_DATA = dict(DATA_CONFIG, max_panel_len=4, max_pattern_len=3)
_NN = {'panel_encoding_size': 8, 'panel_hidden_size': 8, 'panel_n_layers': 2,
       'pattern_encoding_size': 8, 'pattern_hidden_size': 8, 'pattern_n_layers': 2,
       'EConv_hidden': 8, 'EConv_feature': 20, 'k_neighbors': 3, 'skip_connections': True,
       'local_attention': False}


@pytest.fixture(scope='module')
def flax_trees():
    """JAX variables: per encoder, the attention model's with the global
    head (`local_attention` False, the registry's default, so every encoder
    has its `lin`) and an MLP panel decoder; per decoder, the module alone
    as each model builds it in each slot. A module's subtree does not
    depend on the others, so the baseline's variables and any combination
    are assembled from them (its encoder and placement head are the
    attention model's)."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 40, 3)).astype(np.float32))
    models = {}
    for i, (encoder, extra) in enumerate(ENCODERS.items()):
        nn_config = dict(_NN, **extra, panel_decoder='MLPDecoder')
        model = jax_build_model('GarmentSegmentPattern3D', _DATA, nn_config, LOSS_CONFIG,
                                use_pallas=False)
        variables = jax.tree_util.tree_map(      # jitted: eager init takes seconds more
            np.asarray, jax.jit(model.init_variables)(jax.random.PRNGKey(i), x))
        models[encoder, 'GarmentSegmentPattern3D'] = variables
        models[encoder, 'GarmentFullPattern3D'] = {
            col: {k: v for k, v in tree.items()
                  if k in ('feature_extractor', 'placement_decoder')}
            for col, tree in variables.items()}
    # (encoding width, its decoded element width, sequence length) per slot,
    # as garment_pattern_estimation_tpu/models/nets.py builds the decoders
    slots = {'pattern_decoder': (_NN['pattern_encoding_size'], _NN['panel_encoding_size'],
                                 _DATA['max_pattern_len'], _NN['pattern_hidden_size'],
                                 _NN['pattern_n_layers']),
             'panel_decoder': (_NN['panel_encoding_size'], _DATA['element_size'] + 3 + 1,
                               _DATA['max_panel_len'], _NN['panel_hidden_size'],
                               _NN['panel_n_layers'])}
    decoders = {}
    for name in DECODERS:
        for slot, (enc, out, length, hidden, layers) in slots.items():
            module = getattr(jax_blocks, name)(encoding_size=enc, hidden_size=hidden,
                                               out_elem_size=out, n_layers=layers,
                                               out_len=length)
            decoders[name, slot] = _init(module, jnp.zeros((2, enc)))
    return models, decoders


def _assemble(trees, encoder, model_name, panel, pattern=None):
    """The variables of (encoder, panel decoder, pattern decoder)."""
    models, decoders = trees
    base = models[encoder, model_name]
    out = {'params': dict(base['params']), 'batch_stats': dict(base['batch_stats'])}
    for slot, name in (('panel_decoder', panel), ('pattern_decoder', pattern)):
        if name is None:
            continue
        for col in ('params', 'batch_stats'):
            out[col].pop(slot, None)
            if col in decoders[name, slot]:
                out[col][slot] = decoders[name, slot][col]
    return out


@pytest.mark.parametrize('encoder', list(ENCODERS))
def test_state_dict_from_flax_loads_every_combination(flax_trees, encoder):
    """For the encoder: the baseline with every (panel, pattern) decoder
    pair and the attention model with every panel decoder build in the
    port and load the converted variables with every name matched."""
    combos = [('GarmentFullPattern3D', p, q) for p, q in itertools.product(DECODERS, DECODERS)]
    combos += [('GarmentSegmentPattern3D', p, None) for p in DECODERS]
    for model_name, panel, pattern in combos:
        variables = _assemble(flax_trees, encoder, model_name, panel, pattern)
        nn_config = dict(_NN, **ENCODERS[encoder], panel_decoder=panel,
                         **({'pattern_decoder': pattern} if pattern else {}))
        model = build_model(model_name, _DATA, nn_config, device='cpu')
        sd = state_dict_from_flax(variables)
        assert set(sd) == set(model.module.state_dict()), (model_name, panel, pattern)
        model.module.load_state_dict(sd)
