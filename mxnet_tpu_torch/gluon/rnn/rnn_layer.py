"""Fused RNN layers: ``gluon.rnn.RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``.  The reference runs
the whole multi-layer (bi)directional recurrence as one ``lax.scan`` a
direction, XLA and not a Pallas kernel; here it is plain PyTorch, a loop
over T of the reference's step (:func:`run_fused_rnn`), which the
packed-vector ``nd.RNN`` op calls too, so the two agree by construction.
The loop keeps the reference's gate order (LSTM i, f, c, o; GRU r, z,
n, which is also ``torch.nn.LSTM``'s and ``GRU``'s), the layer-then-
direction order, the reversal of the second direction, and inverted
dropout between layers (none after the last).

The input projection of a layer and direction is hoisted out of the
loop: one product over all T steps, ``x W_i2h^T + b_i2h``, and then
``+ (h W_h2h^T + b_h2h)`` a step.  The reference adds the four terms
left to right inside its step; the sums agree to f32 rounding.

Hybridized (``hybridize()``), a layer's call goes through its CachedOp
like any HybridBlock (the reference's layer bypasses its CachedOp: the
scan is one op there), so on the card the whole loop, forward and
backward, is captured as CUDA graphs and a call is one replay, not
T x layers eager launches.  The dropout masks come from the ``nd.random``
generator of the input's device (a standing difference, ROADMAP §3:
the reference's ``jax.random`` key draws other bits; the distribution
agrees).
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ndarray.ndarray import NDArray, apply
from ...ndarray import random as _rnd
from ... import _tape
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU", "run_fused_rnn"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _direction(mode, gi, h, c, whh, bhh, reverse):
    """One direction of one layer over the hoisted input projection
    ``gi`` (T, B, G*H): the outputs (T, B, H) and the final ``h``
    (and ``c``)."""
    steps = range(gi.shape[0] - 1, -1, -1) if reverse else \
        range(gi.shape[0])
    whh_t = whh.t()
    outs = [None] * gi.shape[0]
    for t in steps:
        gh = torch.addmm(bhh, h, whh_t)
        if mode == "lstm":
            i, f, g, o = (gi[t] + gh).chunk(4, 1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            ir, iz, inn = gi[t].chunk(3, 1)
            hr, hz, hn = gh.chunk(3, 1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(gi[t] + gh)
        else:
            h = torch.relu(gi[t] + gh)
        outs[t] = h
    return torch.stack(outs), h, c


def dropout_masks(p, num_layers, shape, device, dtype, training):
    """The keep masks, scaled by ``1 / (1 - p)``, of the dropout between
    layers: one (T, B, H*dirs) mask for each layer but the last, drawn
    from the ``nd.random`` generator of ``device``; ``[]`` outside
    training or with ``p = 0``."""
    if not (p and training and num_layers > 1):
        return []
    gen = _rnd.generator(device)
    return [(torch.rand(shape, generator=gen, device=device) >= p)
            .to(dtype) / (1.0 - p) for _ in range(num_layers - 1)]


def run_fused_rnn(mode, data, states, weights, biases, num_layers, ndir,
                  masks=()):
    """The multi-layer (bi)directional recurrence shared by the gluon
    layers and ``nd.RNN``, on tensors.

    ``data``: (T, B, I), sequence-major.  ``states``: ``(h0,)`` or
    ``(h0, c0)``, each (L*ndir, B, H).  ``weights``/``biases``: for each
    layer, then direction, ``(W_i2h, W_h2h)`` and ``(b_i2h, b_h2h)``.
    ``masks``: :func:`dropout_masks`'s, applied after every layer but
    the last.  Returns ``(out, h_n)`` or ``(out, h_n, c_n)``."""
    if mode not in _GATES:
        raise MXNetError(f"unknown rnn mode {mode}")
    lstm = mode == "lstm"
    T, B = data.shape[0], data.shape[1]
    layer_in = data
    h_out, c_out = [], []
    for layer in range(num_layers):
        dir_outs = []
        for d in range(ndir):
            idx = layer * ndir + d
            wih, whh = weights[idx]
            bih, bhh = biases[idx]
            gi = torch.addmm(bih, layer_in.reshape(T * B, -1), wih.t()) \
                .view(T, B, -1)
            out, h, c = _direction(mode, gi, states[0][idx],
                                   states[1][idx] if lstm else None,
                                   whh, bhh, reverse=d == 1)
            dir_outs.append(out)
            h_out.append(h)
            if lstm:
                c_out.append(c)
        layer_in = dir_outs[0] if ndir == 1 else torch.cat(dir_outs, -1)
        if layer < len(masks):
            layer_in = layer_in * masks[layer]
    outs = (layer_in, torch.stack(h_out))
    if lstm:
        outs = outs + (torch.stack(c_out),)
    return outs


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for layer in range(num_layers):
                for d in self._dirs():
                    in_sz = ni if layer == 0 else nh * self._dir
                    setattr(self, f"{d}{layer}_i2h_weight", self.params.get(
                        f"{d}{layer}_i2h_weight",
                        shape=(ng * nh, in_sz if in_sz else 0),
                        init=i2h_weight_initializer, allow_deferred_init=True))
                    setattr(self, f"{d}{layer}_h2h_weight", self.params.get(
                        f"{d}{layer}_h2h_weight", shape=(ng * nh, nh),
                        init=h2h_weight_initializer))
                    setattr(self, f"{d}{layer}_i2h_bias", self.params.get(
                        f"{d}{layer}_i2h_bias", shape=(ng * nh,),
                        init=i2h_bias_initializer))
                    setattr(self, f"{d}{layer}_h2h_bias", self.params.get(
                        f"{d}{layer}_h2h_bias", shape=(ng * nh,),
                        init=h2h_bias_initializer))

    def _dirs(self):
        return ["l", "r"] if self._dir == 2 else ["l"]

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as nd
        func = func or nd.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def infer_shape(self, x, *args):
        ng, nh = self._gates, self._hidden_size
        for d in self._dirs():
            getattr(self, f"{d}0_i2h_weight").shape_updated(
                (ng * nh, x.shape[-1]))

    def _param_list(self):
        return [f"{d}{layer}_{part}" for layer in range(self._num_layers)
                for d in self._dirs()
                for part in ("i2h_weight", "h2h_weight", "i2h_bias",
                             "h2h_bias")]

    def forward(self, inputs, states=None):
        skip_states = states is None
        if skip_states:
            batch_size = inputs.shape[self._layout.find("N")]
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, NDArray):
            states = [states]
        names = self._param_list()
        if any(self._reg_params[n]._nd is None for n in names):
            self._deferred_init_params(inputs)
        params = [self._reg_params[n].data() for n in names]
        out, out_states = self._fused_forward(inputs, list(states), params)
        return out if skip_states else (out, out_states)

    def _fused_forward(self, inputs, states, params):
        mode, layout, ndir = self._mode, self._layout, self._dir
        num_layers, n_states = self._num_layers, len(states)
        x = inputs.data
        T, B = (x.shape[0], x.shape[1]) if layout == "TNC" else \
            (x.shape[1], x.shape[0])
        masks = dropout_masks(self._dropout, num_layers,
                              (T, B, self._hidden_size * ndir), x.device,
                              x.dtype, _tape.is_training())

        def fn(x, *flat):
            state_arrs = flat[:n_states]
            w = flat[n_states:]
            data = x if layout == "TNC" else x.transpose(0, 1)
            outs = run_fused_rnn(
                mode, data, state_arrs,
                [(w[i], w[i + 1]) for i in range(0, len(w), 4)],
                [(w[i + 2], w[i + 3]) for i in range(0, len(w), 4)],
                num_layers, ndir, masks)
            out = outs[0] if layout == "TNC" else outs[0].transpose(0, 1)
            return (out,) + outs[1:]

        results = apply(fn, [inputs] + states + params, n_out=1 + n_states)
        return results[0], list(results[1:])

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    """Elman RNN, relu or tanh (reference gluon.rnn.RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference gluon.rnn.LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (reference gluon.rnn.GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
