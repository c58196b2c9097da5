"""``gluon.contrib.rnn`` (counterpart of ``mxnet_tpu/gluon/contrib/rnn.py``):
``VariationalDropoutCell``, one dropout mask for every step of a
sequence (Gal and Ghahramani), and ``Conv2DLSTMCell``, whose gates are
2-D convolutions.  The masks come from the ``nd.random`` generator of
the step's device (the reference's ``jax.random`` key draws other bits;
the distribution agrees)."""
from __future__ import annotations

import torch

from ... import _tape
from ...ndarray import random as _rnd
from ...ndarray.ndarray import apply
from .. import nn
from ..rnn.rnn_cell import HybridRecurrentCell

__all__ = ["VariationalDropoutCell", "Conv2DLSTMCell"]


class VariationalDropoutCell(HybridRecurrentCell):
    """Wrap ``base_cell`` and apply the same dropout masks at every step
    to its inputs, first state and outputs, drawn at the first step
    after ``reset`` (``unroll`` resets)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._masks = {}

    def reset(self):
        super().reset()
        # RecurrentCell.__init__ calls reset() before base_cell is set
        if getattr(self, "base_cell", None) is not None:
            self.base_cell.reset()
        self._masks = {}

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size=batch_size, **kwargs)

    def _masked(self, what, p, x):
        """``x`` times the sequence's mask ``what``, drawn now if it is
        not yet (inverted dropout: kept entries scaled by 1 / (1 - p))."""
        if what not in self._masks:
            if not (p and _tape.is_training()):
                return x
            t = x.data
            keep = torch.rand(t.shape, generator=_rnd.generator(t.device),
                              device=t.device) >= p
            self._masks[what] = keep.to(t.dtype) / (1.0 - p)
        mask = self._masks[what]
        return apply(lambda t: t * mask, [x])

    def __call__(self, inputs, states):
        inputs = self._masked("inputs", self._drop_inputs, inputs)
        if self._drop_states:
            states = [self._masked("states", self._drop_states,
                                   states[0])] + list(states[1:])
        out, next_states = self.base_cell(inputs, states)
        return self._masked("outputs", self._drop_outputs, out), next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs, valid_length)


class Conv2DLSTMCell(HybridRecurrentCell):
    """Convolutional LSTM: the gates i, f, c, o are same-padded 2-D
    convolutions of the input (``i2h``, with bias) and of the hidden
    state (``h2h``, without); input and states (B, C, H, W)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), **kwargs):
        super().__init__(**kwargs)
        self._input_shape = tuple(input_shape)    # (C, H, W)
        self._hc = hidden_channels
        with self.name_scope():
            self.i2h = nn.Conv2D(4 * hidden_channels, i2h_kernel,
                                 padding=tuple(k // 2 for k in i2h_kernel),
                                 in_channels=self._input_shape[0])
            self.h2h = nn.Conv2D(4 * hidden_channels, h2h_kernel,
                                 padding=tuple(k // 2 for k in h2h_kernel),
                                 use_bias=False, in_channels=hidden_channels)

    def state_info(self, batch_size=0):
        _, h, w = self._input_shape
        shape = (batch_size, self._hc, h, w)
        return [{"shape": shape, "__layout__": "NCHW"},
                {"shape": shape, "__layout__": "NCHW"}]

    def _alias(self):
        return "conv_lstm"

    def __call__(self, inputs, states):
        gates = self.i2h(inputs) + self.h2h(states[0])

        def fn(g, c_prev):
            i, f, c_in, o = g.chunk(4, 1)
            c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(c_in)
            return torch.tanh(c) * torch.sigmoid(o), c

        out, c = apply(fn, [gates, states[1]], n_out=2)
        return out, [out, c]
