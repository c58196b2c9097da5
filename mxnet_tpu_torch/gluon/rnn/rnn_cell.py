"""Gluon RNN cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: ``RecurrentCell``,
``HybridRecurrentCell``, ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``SequentialRNNCell``, ``DropoutCell``, ``ZoneoutCell``, ``ResidualCell``
and ``BidirectionalCell``, with ``begin_state``, ``unroll`` (layouts
``NTC`` and ``TNC``, ``merge_outputs``, ``valid_length``) and
``state_info``.  The gate math is the reference's (``i2h = x W_i2h^T +
b_i2h``; LSTM gates i, f, c, o; GRU r, z, n), so weights carry across by
name.  As in the reference, a cell's call is one step, run as plain ops
(a cell does not go through a CachedOp; a hybridized block that calls
it captures its steps).  ``ZoneoutCell`` and ``DropoutCell`` draw from
the ``nd.random`` generator of the step's device.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


class RecurrentCell(HybridBlock):
    """Base class of the cells (reference ``RecurrentCell``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters, here and in the child cells."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func(shape=..., **kwargs)`` each
        (``nd.zeros`` by default; pass ``ctx=`` for the device)."""
        from ... import ndarray as nd
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` (one NDArray in
        ``layout``); returns ``(outputs, states)``, the outputs merged
        into one NDArray when ``merge_outputs`` is true, else a list."""
        from ... import ndarray as nd
        axis = layout.find("T")
        if begin_state is None:
            begin_state = self.begin_state(inputs.shape[layout.find("N")],
                                           ctx=inputs.context)
        states = begin_state
        seq = nd.split(inputs, num_outputs=length, axis=axis,
                       squeeze_axis=True) if length > 1 else \
            [inputs.squeeze(axis)]
        outputs = []
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
        if valid_length is not None:
            outputs = [nd.SequenceMask(
                nd.stack(*outputs, axis=axis), sequence_length=valid_length,
                use_sequence_length=True, axis=axis)]
            if merge_outputs is False:
                outputs = nd.split(outputs[0], num_outputs=length, axis=axis,
                                   squeeze_axis=True)
        elif merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        if merge_outputs and isinstance(outputs, list) and len(outputs) == 1:
            outputs = outputs[0]
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return self.forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    """A cell whose step is ``hybrid_forward`` (reference
    ``HybridRecurrentCell``)."""


class RNNCell(HybridRecurrentCell):
    """Elman step: ``act(x W_i2h^T + b_i2h + h W_h2h^T + b_h2h)``."""

    _n_gates = 1

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self._make_params(i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer)

    def _make_params(self, i2h_w, h2h_w, i2h_b, h2h_b):
        rows, nh = self._n_gates * self._hidden_size, self._hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(rows, self._input_size), init=i2h_w,
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(rows, nh), init=h2h_w)
            self.i2h_bias = self.params.get("i2h_bias", shape=(rows,),
                                            init=i2h_b)
            self.h2h_bias = self.params.get("h2h_bias", shape=(rows,),
                                            init=h2h_b)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape_updated((self._n_gates * self._hidden_size,
                                       x.shape[-1]))

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._n_gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(RNNCell):
    """LSTM step, gates i, f, c, o (reference ``LSTMCell``)."""

    _n_gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        HybridRecurrentCell.__init__(self, prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        self._make_params(i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        gates = F.split(i2h + h2h, num_outputs=4, axis=1)
        rec, act = self._recurrent_activation, self._activation
        in_gate = self._get_activation(F, gates[0], rec)
        forget_gate = self._get_activation(F, gates[1], rec)
        in_transform = self._get_activation(F, gates[2], act)
        out_gate = self._get_activation(F, gates[3], rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, act)
        return next_h, [next_h, next_c]


class GRUCell(RNNCell):
    """GRU step, gates r, z, n (reference ``GRUCell``)."""

    _n_gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        HybridRecurrentCell.__init__(self, prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._make_params(i2h_weight_initializer, h2h_weight_initializer,
                          i2h_bias_initializer, h2h_bias_initializer)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, **params):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, **params)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n,
                                  act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, batch_size, **kwargs):
    return sum([c.begin_state(batch_size, **kwargs) for c in cells], [])


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, the states
    concatenated (reference ``SequentialRNNCell``)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state(self._children.values(), batch_size,
                                  **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class DropoutCell(HybridRecurrentCell):
    """Dropout on the step's input (reference ``DropoutCell``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell that wraps ``base_cell`` (reference ``ModifierCell``)."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout on the outputs and the states: each element keeps its
    previous value with probability ``zoneout_*`` (reference
    ``ZoneoutCell``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def __call__(self, inputs, states):
        from ...ndarray import random as _rnd
        next_output, next_states = self.base_cell(inputs, states)
        ctx = next_output.context
        if self.zoneout_outputs > 0:
            mask = _rnd.bernoulli(self.zoneout_outputs,
                                  shape=next_output.shape, ctx=ctx)
            prev = self._prev_output if self._prev_output is not None else \
                next_output * 0
            next_output = mask * prev + (1 - mask) * next_output
        if self.zoneout_states > 0:
            next_states = [
                m * s + (1 - m) * ns for ns, s, m in (
                    (ns, s, _rnd.bernoulli(self.zoneout_states,
                                           shape=ns.shape, ctx=ctx))
                    for ns, s in zip(next_states, states))]
        self._prev_output = next_output
        return next_output, next_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input (reference
    ``ResidualCell``)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward in time, outputs
    concatenated (reference ``BidirectionalCell``; only ``unroll``)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return _cells_state_info([self.l_cell, self.r_cell], batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state([self.l_cell, self.r_cell], batch_size,
                                  **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        axis = layout.find("T")
        if begin_state is None:
            begin_state = self.begin_state(inputs.shape[layout.find("N")],
                                           ctx=inputs.context)
        n_l = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state[:n_l], layout, True,
            valid_length=valid_length)

        def reverse(x):
            # SequenceReverse runs along axis 0
            x = x.swapaxes(0, 1) if axis == 1 else x
            x = nd.SequenceReverse(x, sequence_length=valid_length,
                                   use_sequence_length=valid_length
                                   is not None)
            return x.swapaxes(0, 1) if axis == 1 else x
        r_out, r_states = self.r_cell.unroll(
            length, reverse(inputs), begin_state[n_l:], layout, True,
            valid_length=valid_length)
        outputs = nd.concat(l_out, reverse(r_out), dim=2)
        if merge_outputs is False:
            outputs = nd.split(outputs, num_outputs=length, axis=axis,
                               squeeze_axis=True)
        return outputs, l_states + r_states

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")
