"""Plain PyTorch reference of NeuralTailor's pattern-shape models, written
from the published description and independent of the program: the served
forward of the attention model (`GarmentSegmentPattern3D`) and of the
baseline (`GarmentFullPattern3D`), and the attention model's training
step with its loss and Adam.

Parameters are a dict {name: tensor} in the NeuralTailor state-dict naming
(`param_spec`), which the benchmark draws from the seed and hands to both
the program and this reference.

Precision, as each configuration states it (`precision` in its file):
  * f32 everywhere, every product at full f32 (TF32 off), except
  * the served EdgeConv layer (`served_edge_mlp`): its BatchNorms folded
    into the next Dense in f32, the folded weights rounded to bf16, each
    layer's input truncated to bf16 (low 16 bits cleared), products
    accumulated in f32.
`lowered=True` is the control: every f32 product takes TF32 inputs (10
mantissa bits, round to nearest) and the bf16 edge MLP takes fp8 (e4m3,
per-tensor scale), the next precision below each.

kNN, as each configuration's `selection` states it: the point itself
first, then the k - 1 nearest others by f32 squared distance (differences
per dimension for C <= 16, |q|^2 + |k|^2 - 2 q.k above), ranked by the
distance with its `dropped_bits` low bits cleared and then by the lower
index; in training past `exact_wide_above_points` points, where C > 16,
by the exact distance. Where C > 16 the neighbours' rows are the sum of
their first two bf16 truncation chunks, in serving and in training up to
`exact_wide_above_points` points; past it whole.
"""
from __future__ import annotations

import math

import torch

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ADAM = {'beta1': 0.9, 'beta2': 0.999, 'eps': 1e-8}
_TRUNC_MASK = -65536                        # 0xFFFF0000 as int32
FP8_MAX = 448.0                             # float8_e4m3fn's largest finite value


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def _edge_widths(nn):
    return [nn['EConv_hidden']] * nn['EConv_hidden_depth'] + [nn['EConv_feature']]


def _mlp_spec(prefix, sizes):
    spec = []
    for j, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        spec += [(f'{prefix}.{j}.0.weight', (fan_out, fan_in), 'linear_w'),
                 (f'{prefix}.{j}.0.bias', (fan_out,), 'bias'),
                 (f'{prefix}.{j}.2.weight', (fan_out,), 'bn_w'),
                 (f'{prefix}.{j}.2.bias', (fan_out,), 'bias'),
                 (f'{prefix}.{j}.2.running_mean', (fan_out,), 'bn_mean'),
                 (f'{prefix}.{j}.2.running_var', (fan_out,), 'bn_var'),
                 (f'{prefix}.{j}.2.num_batches_tracked', (), 'count')]
    return spec


def _lstm_spec(prefix, in_size, hidden, layers):
    spec = []
    for layer in range(layers):
        fan_in = in_size if layer == 0 else hidden
        spec += [(f'{prefix}.weight_ih_l{layer}', (4 * hidden, fan_in), 'lstm_w'),
                 (f'{prefix}.weight_hh_l{layer}', (4 * hidden, hidden), 'lstm_w'),
                 (f'{prefix}.bias_ih_l{layer}', (4 * hidden,), 'lstm_b'),
                 (f'{prefix}.bias_hh_l{layer}', (4 * hidden,), 'lstm_b')]
    return spec


def _linear_spec(prefix, fan_in, fan_out):
    return [(f'{prefix}.weight', (fan_out, fan_in), 'linear_w'),
            (f'{prefix}.bias', (fan_out,), 'bias')]


def dims(config):
    """The sizes the reference needs from a configuration file."""
    nn, data = config['NN'], config['data']
    feature = nn['EConv_feature'] + (3 if nn['skip_connections'] else 0)
    return {'k': nn['k_neighbors'], 'conv_depth': nn['conv_depth'],
            'edge_widths': _edge_widths(nn), 'feature': feature,
            'P': data['max_pattern_len'], 'L': data['max_panel_len'],
            'E': nn['panel_encoding_size'], 'H': nn['panel_hidden_size'],
            'panel_layers': nn['panel_n_layers'],
            'pattern_E': nn['pattern_encoding_size'], 'pattern_H': nn['pattern_hidden_size'],
            'pattern_layers': nn['pattern_n_layers'],
            'element': data['element_size'], 'tags': nn['stitch_tag_dim'],
            'rotation': data['rotation_size'], 'translation': data['translation_size']}


def param_spec(config):
    """[(name, shape, kind)] of every parameter and buffer of the model of
    `config`, in the NeuralTailor state-dict naming."""
    d = dims(config)
    spec, c_in = [], 3
    for i in range(d['conv_depth']):
        spec += _mlp_spec(f'feature_extractor.conv_layers.{i}.nn', [2 * c_in, *d['edge_widths']])
        c_in = d['edge_widths'][-1]
    attention = config['model'] == 'GarmentSegmentPattern3D'
    if attention:
        if not config['NN'].get('local_attention', False):
            raise NotImplementedError('reference: the attention model with local_attention')
    else:
        spec += _linear_spec('feature_extractor.lin', d['feature'], d['pattern_E'])
    spec += _lstm_spec('panel_decoder.lstm', d['E'], d['H'], d['panel_layers'])
    spec += _linear_spec('panel_decoder.lin', d['H'], d['element'] + d['tags'] + 1)
    spec += _linear_spec('placement_decoder', d['E'], d['rotation'] + d['translation'])
    if attention:
        f = d['feature']
        spec += _mlp_spec('point_segment_mlp.0', [f, f, f, d['P']])
        spec += _linear_spec('panel_dec_lin', f, d['E'])
    else:
        spec += _lstm_spec('pattern_decoder.lstm', d['pattern_E'], d['pattern_H'],
                           d['pattern_layers'])
        spec += _linear_spec('pattern_decoder.lin', d['pattern_H'], d['E'])
    return spec


def make_weights(config, seed, device):
    """Every parameter and buffer of `param_spec`, drawn on `device` from a
    generator seeded with `seed` in two calls (one normal, one uniform
    draw), then cut and scaled: Dense kernels N(0, 1/fan_in), biases
    N(0, 0.1^2), BatchNorm scales 1 + N(0, 0.1^2), running means N(0,
    0.1^2), running variances U(0.5, 1.5), LSTM kernels N(0, 2/fan_in) and
    biases U(-1/sqrt(H), 1/sqrt(H))."""
    spec = param_spec(config)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    weights, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        n, u = normal[at:at + size].reshape(shape), uniform[at:at + size].reshape(shape)
        at += size
        if kind == 'linear_w':
            value = n / math.sqrt(shape[1])
        elif kind == 'bias' or kind == 'bn_mean':
            value = 0.1 * n
        elif kind == 'bn_w':
            value = 1.0 + 0.1 * n
        elif kind == 'bn_var':
            value = 0.5 + u
        elif kind == 'lstm_w':
            value = n * math.sqrt(2.0 / shape[1])
        elif kind == 'lstm_b':
            bound = 1.0 / math.sqrt(shape[0] // 4)
            value = (2 * u - 1) * bound
        else:                                                   # BatchNorm counters
            value = torch.zeros((), dtype=torch.int64, device=device)
        weights[name] = value.clone()
    return weights


# ----------------------------------------------------------------------
# arithmetic
# ----------------------------------------------------------------------

def round_tf32(x):
    """f32 rounded to nearest (ties away) at 10 mantissa bits, as TF32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def truncate_bf16(x):
    """f32 with its low 16 bits cleared: truncation to bf16."""
    return (x.contiguous().view(torch.int32) & _TRUNC_MASK).view(torch.float32)


def two_chunks(x):
    """x as the sum of its first two bf16 truncation chunks (16 significant
    bits): the rows the served layer gathers where C > 16."""
    hi = truncate_bf16(x)
    return hi + truncate_bf16(x - hi)


def round_bf16(x):
    return x.to(torch.bfloat16).float()


def fp8(x):
    """f32 through float8_e4m3fn at a per-tensor scale (largest |x| to 448)."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _TF32Product(torch.autograd.Function):
    """a @ b on TF32 inputs, its two backward products on TF32 inputs too.
    `b` is (K, N) or has a's leading axes."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        grad_a = g @ b.transpose(-1, -2)
        if b.dim() == 2:
            grad_b = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        else:
            grad_b = a.transpose(-1, -2) @ g
        return grad_a, grad_b


class Precision:
    """How products are taken: `mm(a, b)` at f32 (TF32 off) or, lowered, on
    TF32 inputs in the forward and the backward; `edge(h, W)` for the served
    edge MLP at its stated bf16 or, lowered, at fp8."""

    def __init__(self, lowered=False):
        self.lowered = lowered

    def mm(self, a, b):
        if self.lowered:
            return _TF32Product.apply(a, b)
        return a @ b

    def edge(self, h, w):
        if self.lowered:
            return fp8(h) @ fp8(w)
        return truncate_bf16(h) @ round_bf16(w)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

def sq_dists(q, keys, prec):
    """(G, S, C) queries x (G, T, C) keys -> (G, S, T) f32 squared distances."""
    if q.shape[-1] <= 16:
        d = None
        for c in range(q.shape[-1]):
            diff = q[:, :, None, c] - keys[:, None, :, c]
            d = diff * diff if d is None else d + diff * diff
        return d
    q_norm = (q * q).sum(-1)
    k_norm = (keys * keys).sum(-1)
    return q_norm[:, :, None] + k_norm[:, None, :] - 2.0 * prec.mm(q, keys.transpose(1, 2))


def order_preserving(d):
    """f32 -> int32 whose order is the float order (-0 equal to +0)."""
    bits = (d + 0.0).contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def knn(x, k, prec, dropped_bits=0, block=2048):
    """ids (B, N, k) int64: the point itself, then its k - 1 nearest others
    by (distance with `dropped_bits` low bits cleared, index)."""
    x = x.detach()
    B, N, _ = x.shape
    k = min(k, N)
    col = torch.arange(N, device=x.device)
    out = []
    for s in range(0, N, block):
        d = sq_dists(x[:, s:s + block], x, prec)
        if dropped_bits:
            ranked = d.clamp_min(0.0).view(torch.int32) & ~((1 << dropped_bits) - 1)
        else:
            ranked = order_preserving(d)
        del d
        key = (ranked.to(torch.int64) << 32) | col
        del ranked
        rows = col[s:s + block]
        key[:, rows - s, rows] = torch.iinfo(torch.int64).max
        rest = torch.topk(key, k - 1, dim=-1, largest=False, sorted=True).values & 0xFFFFFFFF
        out.append(torch.cat([rows[None, :, None].expand(B, len(rows), 1), rest], dim=-1))
    return torch.cat(out, dim=1)


def gather_rows(x, ids):
    """(B, N, C), ids (B, M, k) -> (B, M, k, C)."""
    B, N, C = x.shape
    flat = (ids + (torch.arange(B, device=x.device) * N)[:, None, None]).reshape(-1)
    return x.reshape(B * N, C)[flat].reshape(*ids.shape, C)


def edge_input(x, ids, rows):
    """[x_i ; x_j - x_i] for each chosen neighbour j of each point i, x_j
    read from `rows` but for the point itself (slot 0)."""
    nbr = gather_rows(rows, ids[:, :, 1:])
    center = x[:, :, None, :]
    nbr = torch.cat([center, nbr], dim=2)
    center = center.expand_as(nbr)
    return torch.cat([center, nbr - center], dim=-1)


def mlp_layers(w, prefix):
    layers, j = [], 0
    while f'{prefix}.{j}.0.weight' in w:
        layers.append(tuple(w[f'{prefix}.{j}.{s}'] for s in (
            '0.weight', '0.bias', '2.weight', '2.bias', '2.running_mean', '2.running_var')))
        j += 1
    return layers


def mlp_eval(x, layers, prec):
    """Linear -> ReLU -> BatchNorm on the running statistics, every layer."""
    for W, b, g, beta, mean, var in layers:
        x = torch.relu(prec.mm(x, W.t()) + b)
        x = (x - mean) / torch.sqrt(var + BN_EPS) * g + beta
    return x


def mlp_train(x, layers, prec, stats):
    """Linear -> ReLU -> BatchNorm on the batch's statistics (mean and
    biased variance over every leading axis), every layer; appends each
    layer's (mean, variance) to `stats`."""
    for W, b, g, beta, _, _ in layers:
        x = torch.relu(prec.mm(x, W.t()) + b)
        rows = x.reshape(-1, x.shape[-1])
        mean = rows.mean(0)
        var = ((rows - mean) ** 2).mean(0)
        stats.append((mean.detach(), var.detach()))
        x = (x - mean) / torch.sqrt(var + BN_EPS) * g + beta
    return x


def folded(layers):
    """The served edge MLP's layers with each BatchNorm folded into the next
    Dense: [(W (in, out), b)] and the last BatchNorm's affine (a, d)."""
    out, a_prev, d_prev = [], None, None
    for W, b, g, beta, mean, var in layers:
        W, b = W.t(), b
        if a_prev is not None:
            b = b + d_prev @ W
            W = a_prev[:, None] * W
        out.append((W, b))
        a_prev = g / torch.sqrt(var + BN_EPS)
        d_prev = beta - mean * a_prev
    return out, (a_prev, d_prev)


def edgeconv_eval(x, layers, k, prec, selection, block=1024):
    """The served EdgeConv layer: kNN, the folded edge MLP at the served
    precision, the max over the k neighbours."""
    ids = knn(x, k, prec, selection['dropped_bits'])
    fold, (a, d) = folded(layers)
    rows = x if x.shape[-1] <= 16 else two_chunks(x)
    out = []
    for s in range(0, x.shape[1], block):
        nbr = gather_rows(rows, ids[:, s:s + block])
        nbr[:, :, 0] = x[:, s:s + block]
        center = x[:, s:s + block, None, :].expand_as(nbr)
        h = torch.cat([center, nbr - center], dim=-1)
        for W, b in fold:
            h = torch.relu(prec.edge(h, W) + b)
        out.append(torch.amax(h * a + d, dim=2))
    return torch.cat(out, dim=1)


def edgeconv_train(x, layers, k, prec, selection, stats):
    """The training EdgeConv layer. Up to `exact_wide_above_points` points
    the wide rows (C > 16) are gathered as two bf16 chunks, their gradient
    passed through whole; past it, by the exact ranking and whole rows."""
    wide = x.shape[-1] > 16
    whole = x.shape[1] > selection['exact_wide_above_points']
    ids = knn(x, k, prec, 0 if whole and wide else selection['dropped_bits'])
    rows = x + (two_chunks(x) - x).detach() if wide and not whole else x
    return torch.amax(mlp_train(edge_input(x, ids, rows), layers, prec, stats), dim=2)


def lstm(x, w, prefix, layers, states, prec):
    """A multi-layer LSTM (gates i, f, g, o) over (R, T, in) from
    [(h0, c0)] per layer."""
    for layer in range(layers):
        W_ih, W_hh = w[f'{prefix}.weight_ih_l{layer}'], w[f'{prefix}.weight_hh_l{layer}']
        bias = w[f'{prefix}.bias_ih_l{layer}'] + w[f'{prefix}.bias_hh_l{layer}']
        gates_x = prec.mm(x, W_ih.t()) + bias
        h, c = states[layer]
        outs = []
        for t in range(x.shape[1]):
            i, f, g, o = (gates_x[:, t] + prec.mm(h, W_hh.t())).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, dim=1)
    return x


def initial_states(rows, hidden, layers, device, generator):
    """Zeros without a generator; else N(0, 2 / (rows hidden)) draws, h then
    c for each layer: the published recipe's `kaiming_normal_` states."""
    if generator is None:
        zero = torch.zeros(rows, hidden, device=device)
        return [(zero, zero)] * layers
    std = math.sqrt(2.0 / (rows * hidden))
    return [tuple(torch.randn(rows, hidden, generator=generator, device=generator.device)
                  .to(device) * std for _ in range(2)) for _ in range(layers)]


def linear(x, w, prefix, prec):
    return prec.mm(x, w[f'{prefix}.weight'].t()) + w[f'{prefix}.bias']


def sparsemax(z):
    """The Euclidean projection of each row onto the probability simplex."""
    zs = torch.sort(z, dim=-1, descending=True).values
    k = torch.arange(1, z.shape[-1] + 1, device=z.device, dtype=z.dtype)
    cum = zs.cumsum(-1)
    support = (1 + k * zs > cum).sum(-1, keepdim=True)
    tau = (cum.gather(-1, support - 1) - 1) / support.to(z.dtype)
    return torch.clamp_min(z - tau, 0.0)


# ----------------------------------------------------------------------
# models
# ----------------------------------------------------------------------

class Reference:
    """The model of a configuration file on the weights `w`."""

    def __init__(self, config, weights, lowered=False):
        self.config = config
        self.d = dims(config)
        self.w = weights
        self.prec = Precision(lowered)
        self.attention = config['model'] == 'GarmentSegmentPattern3D'
        self.selection = config['selection']

    def _conv_layers(self):
        return [mlp_layers(self.w, f'feature_extractor.conv_layers.{i}.nn')
                for i in range(self.d['conv_depth'])]

    def _decode(self, enc, generator):
        """Panel encodings (B, P, E) -> the prediction dict (standardized)."""
        d, w, prec = self.d, self.w, self.prec
        B, P, E = enc.shape
        flat = enc.reshape(B * P, E)
        states = initial_states(B * P, d['H'], d['panel_layers'], enc.device, generator)
        seq = lstm(flat[:, None, :].expand(B * P, d['L'], E), w, 'panel_decoder.lstm',
                   d['panel_layers'], states, prec)
        panels = linear(seq, w, 'panel_decoder.lin', prec).reshape(B, P, d['L'], -1)
        place = linear(flat, w, 'placement_decoder', prec).reshape(B, P, -1)
        el = d['element']
        return {'outlines': panels[..., :el], 'stitch_tags': panels[..., el:-1],
                'free_edges_mask': panels[..., -1], 'rotations': place[..., :d['rotation']],
                'translations': place[..., d['rotation']:]}

    def _head(self, feats, positions, train, stats, generator):
        """Per-point features (B, N, F) -> the prediction dict."""
        d, w, prec = self.d, self.w, self.prec
        if self.config['NN']['skip_connections']:
            feats = torch.cat([feats, positions], dim=-1)
        if self.attention:
            layers = mlp_layers(w, 'point_segment_mlp.0')
            logits = mlp_train(feats, layers, prec, stats) if train \
                else mlp_eval(feats, layers, prec)
            weights = sparsemax(logits)
            pooled = prec.mm(weights.transpose(1, 2), feats) / feats.shape[1]
            preds = self._decode(linear(pooled, w, 'panel_dec_lin', prec), generator)
            preds['att_weights'] = weights
            return preds
        encoding = linear(feats.mean(dim=1), w, 'feature_extractor.lin', prec)
        B = encoding.shape[0]
        states = initial_states(B, d['pattern_H'], d['pattern_layers'], encoding.device,
                                generator)
        seq = lstm(encoding[:, None, :].expand(B, d['P'], encoding.shape[-1]), w,
                   'pattern_decoder.lstm', d['pattern_layers'], states, prec)
        return self._decode(linear(seq, w, 'pattern_decoder.lin', prec), generator)

    @torch.no_grad()
    def serve(self, points):
        """The served path: physical clouds (B, N, 3) -> physical predictions."""
        std = self.config['data']['standardize']
        dev = points.device

        def vec(values):
            return torch.as_tensor(values, dtype=torch.float32, device=dev)

        x = (points.float() - vec(std['f_shift'])) / vec(std['f_scale'])
        feats = x
        for layers in self._conv_layers():
            feats = edgeconv_eval(feats, layers, self.d['k'], self.prec, self.selection)
        preds = self._head(feats, x, False, None, None)
        return {key: value * vec(std['gt_scale'][key]) + vec(std['gt_shift'][key])
                if key in std['gt_shift'] else value for key, value in preds.items()}

    def train_forward(self, x, generator, stats):
        feats = x
        for layers in self._conv_layers():
            feats = edgeconv_train(feats, layers, self.d['k'], self.prec, self.selection, stats)
        return self._head(feats, x, True, stats, generator)

    def loss(self, preds, gt):
        """The shape, loop, rotation and translation terms of the published
        attention recipe (loop weight 1), summed."""
        pad = pad_vector(self.config['data'], preds['outlines'].device)
        outlines = preds['outlines']
        shape = ((outlines - gt['outlines']) ** 2).mean()
        panels = outlines.reshape(-1, *outlines.shape[-2:])
        ne = gt['num_edges'].reshape(-1).long()
        in_loop = torch.arange(panels.shape[1], device=ne.device)[None, :] < ne[:, None]
        loop_sum = torch.where(in_loop[..., None], panels[..., :2] - pad[:2], 0.0).sum(1)
        loop_sum = torch.where((ne >= 3)[:, None], loop_sum, 0.0)
        loop = (loop_sum ** 2).sum() / (panels.shape[0] * 2)
        weight = self.config['loss'].get('loop_loss_weight', 1.0)
        rotation = ((preds['rotations'] - gt['rotations']) ** 2).mean()
        translation = ((preds['translations'] - gt['translations']) ** 2).mean()
        return shape + weight * loop + rotation + translation


def pad_vector(data_config, device):
    std = data_config['standardize']
    shift = torch.as_tensor(std['gt_shift']['outlines'], dtype=torch.float32, device=device)
    scale = torch.as_tensor(std['gt_scale']['outlines'], dtype=torch.float32, device=device)
    return -shift / scale


def onecycle_lr(step, total_steps, peak, pct_start=0.3, div_factor=25.0,
                final_div_factor=1e4):
    """The one-cycle (cosine) learning rate at `step` of `total_steps`: from
    peak / div_factor up to peak over int(pct_start total) steps, then down
    to peak / (div_factor final_div_factor)."""
    start = peak / div_factor
    end = start / final_div_factor
    up = int(pct_start * total_steps)
    if step < up:
        return peak + (start - peak) / 2 * (math.cos(math.pi * step / up) + 1)
    if step < total_steps:
        pct = (step - up) / (total_steps - up)
        return end + (peak - end) / 2 * (math.cos(math.pi * pct) + 1)
    return end


def train_steps(config, weights, batches, generators, lrs, lowered=False):
    """The attention model's training steps on `batches` (each
    {'features', 'ground_truth'}), step i drawing its LSTM states from
    generators[i] at learning rate lrs[i]: Adam, BatchNorm running
    averages at momentum 0.1 of the biased variance. Returns {'losses':
    [...], 'grad1': {name: gradient of step 1}, 'params': {name: after the
    last step}, 'buffers': {name: running statistics after it}}."""
    w = {name: (t.clone().requires_grad_(True) if t.is_floating_point() else t.clone())
         for name, t in weights.items() if not name.endswith(('running_mean', 'running_var'))}
    buffers = {name: t.clone() for name, t in weights.items()
               if name.endswith(('running_mean', 'running_var'))}
    params = {name: t for name, t in w.items() if t.is_floating_point()}
    m = {name: torch.zeros_like(p) for name, p in params.items()}
    v = {name: torch.zeros_like(p) for name, p in params.items()}
    losses, grad1 = [], None
    for step, (batch, gen, lr) in enumerate(zip(batches, generators, lrs)):
        model = Reference(config, {**w, **buffers}, lowered)
        stats = []
        preds = model.train_forward(batch['features'].float(), gen, stats)
        loss = model.loss(preds, batch['ground_truth'])
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        losses.append(loss.item())
        if grad1 is None:
            grad1 = {name: g.detach().clone() for name, g in grads.items()}
        t = step + 1
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name]
                m[name].mul_(ADAM['beta1']).add_(g, alpha=1 - ADAM['beta1'])
                v[name].mul_(ADAM['beta2']).addcmul_(g, g, value=1 - ADAM['beta2'])
                m_hat = m[name] / (1 - ADAM['beta1'] ** t)
                v_hat = v[name] / (1 - ADAM['beta2'] ** t)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM['eps']))
            _update_running(buffers, stats, model)
    return {'losses': losses, 'grad1': grad1,
            'params': {name: p.detach() for name, p in params.items()}, 'buffers': buffers}


def _update_running(buffers, stats, model):
    """Each BatchNorm's running averages from its batch (mean, variance), in
    the order `train_forward` used the layers."""
    prefixes = [f'feature_extractor.conv_layers.{i}.nn' for i in range(model.d['conv_depth'])]
    if model.attention:
        prefixes.append('point_segment_mlp.0')
    names = [f'{prefix}.{j}.2' for prefix in prefixes
             for j in range(len(mlp_layers(model.w, prefix)))]
    for name, (mean, var) in zip(names, stats, strict=True):
        buffers[f'{name}.running_mean'].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        buffers[f'{name}.running_var'].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
