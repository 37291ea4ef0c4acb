"""BENCHMARK.json against the rules a manifest keeps (names, units, bounds,
cells, metrics), and the imports of every module of the benchmark."""
import ast
import re

import pytest

from benchmark import common

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TOP_KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
WIDTH = re.compile(r'(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|feature|'
                   r'expansion|experts_per_token|_size$')


@pytest.fixture(scope='module')
def bench():
    return common.manifest()


def test_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= bench['run_seconds'] <= 51
    assert bench['paths'] == ['benchmark']
    names = [x['name'] for key in ('configs', 'workloads', 'end_to_end', 'per_layer')
             for x in bench[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for metric in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(metric['unit']), metric['unit']
        assert metric['better'] in ('lower', 'higher')
    assert len((common.ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_configs(bench):
    used = {w['config'] for w in bench['workloads']}
    for config in bench['configs']:
        assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
        assert config['name'] in used
        assert config['file'].startswith('benchmark/configs/')
        assert (common.ROOT / config['file']).exists()
        for key in config['reduced']:
            assert NAME.match(key) and not WIDTH.search(key), key


def test_workloads(bench):
    pairs = set()
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and 1 <= len(w['why']) <= 200
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
        cell = common.cell(w['name'], bench)             # every file the cell needs
        assert cell['traffic']['entry'] in ('serve', 'train')
    four = sum(w['chips'] == 4 for w in bench['workloads'])
    assert four <= max(1, len(bench['workloads']) // 4)


def test_metrics(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for w in bench['workloads']:
        names, per_layer = common.metrics_of(w['name'], bench)
        assert 'setup_s' in {m['name'] for m in names} and len(names) >= 2
        assert per_layer, w['name']
    for m in bench['per_layer']:
        assert m['moves'] in e2e
        for cell in m['workloads']:
            assert cell in e2e[m['moves']].get('workloads', [cell]), (m['name'], cell)
        assert callable(common.load_reader(m['name']))
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
    layers = {m['layer'] for m in bench['per_layer']}
    assert all(layer and '\n' not in layer for layer in layers)


def test_limits_cover_every_cell(bench):
    for w in bench['workloads']:
        limits = common.cell(w['name'], bench)['limits']['numbers']
        assert limits and all(v > 0 for v in limits.values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in sorted(common.HERE.rglob('*.py')):
        for name in _imports(path):
            assert name.split('.', 1)[0] not in common.FORBIDDEN_MODULES, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((common.HERE / 'reference').rglob('*.py')):
        for name in _imports(path):
            top = name.split('.', 1)[0]
            assert top in ('__future__', 'math', 'statistics', 'torch'), (path, name)


def test_split_metrics_find_their_quantity():
    assert common.quantity('serve_clouds_per_s.n2000', {'serve_clouds_per_s'}) == \
        'serve_clouds_per_s'
    assert common.quantity('launches_per_batch.serve.n2000', {'launches_per_batch.serve'}) == \
        'launches_per_batch.serve'
    with pytest.raises(KeyError):
        common.quantity('x.n2000', {'y'})


def test_forbidden_names_are_compared_whole():
    assert common.forbidden_loaded(['garment_pattern_estimation_torch.ops', 'jaxtyping']) == []
    assert common.forbidden_loaded(['jax.numpy', 'garment_pattern_estimation_tpu']) == [
        'garment_pattern_estimation_tpu', 'jax']
