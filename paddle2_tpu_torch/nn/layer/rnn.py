"""The recurrent layers: the counterpart of
``paddle2_tpu/nn/layer/rnn.py``.

Each cell has a pure ``step(x_t, states, *params)`` with the JAX cell's
formulas and gate order (``rnn.py:93-172``: GRU r, z, c; LSTM i, f, g,
o), and its weights are uniform in ±1/√hidden. ``RNN`` is a loop over
time in plain torch ops on either device (the JAX package's
``lax.scan``), with ``time_major`` and ``is_reverse``; ``BiRNN``
concatenates the two directions on the last axis. ``_RNNBase`` splits
initial states packed as Paddle packs them (``[layers * directions,
batch, hidden]``, an ``(h, c)`` pair for LSTM) per layer and direction,
applies dropout between layers only, and returns the final states as a
list with one entry per layer.

The JAX package's quirks, kept:

- ``sequence_length`` and LSTM's ``proj_size`` are taken and ignored;
- ``get_initial_states`` makes float32 states whatever the input's
  dtype. Under ``auto_cast`` they are cast with the op's other inputs
  (O2 casts every op but the black list's), but a bfloat16 model run
  without it meets float32 states: the products and gates then promote
  to float32 as JAX promotes them, and so do the outputs and the
  carried states;
- the AMP name of a whole sequence is ``"rnn_scan"`` (on the white
  list), and that of a bare cell's call its class name (``"LSTMCell"``),
  which no list names: O1 casts the first and not the second.
"""

import math

import torch
import torch.nn.functional as TF

from ...amp.casting import cast_call
from ...ops import manipulation
from .. import functional as F
from .. import initializer as I
from .container import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "GRUCell", "LSTMCell", "RNN",
           "SimpleRNN", "GRU", "LSTM", "BiRNN"]


def _mm(a, w):
    """``a @ w.T`` in the promotion of their dtypes, as ``jnp.matmul``
    takes mixed operands."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(dt), w.to(dt).t())


def _pack(states):
    """``(single, list of states)``: a cell's one state tensor or its
    tuple of them."""
    single = not isinstance(states, (tuple, list))
    return single, [states] if single else list(states)


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        dt = dtype or "float32"
        dt = getattr(torch, dt) if isinstance(dt, str) else dt

        def full(s):
            return torch.full([batch] + list(s), init_value, dtype=dt,
                              device=batch_ref.device)
        if isinstance(self.state_shape[0], (list, tuple)):
            return tuple(full(s) for s in self.state_shape)
        return full(self.state_shape)

    def _params(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)

    def _extra(self):
        return {}

    @staticmethod
    def step(x, states, wi, wh, bi, bh):
        raise NotImplementedError

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        single, state_list = _pack(states)
        step, extra = type(self).step, self._extra()

        def fn(x, st, params):
            return step(x, tuple(st), *params, **extra)
        out, new = cast_call(type(self).__name__, fn, inputs,
                             tuple(state_list), self._params())
        return out, (new[0] if single else tuple(new))


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [hidden_size, input_size], weight_ih_attr, default_initializer=u)
        self.weight_hh = self.create_parameter(
            [hidden_size, hidden_size], weight_hh_attr,
            default_initializer=u)
        self.bias_ih = self.create_parameter(
            [hidden_size], bias_ih_attr, is_bias=True, default_initializer=u)
        self.bias_hh = self.create_parameter(
            [hidden_size], bias_hh_attr, is_bias=True, default_initializer=u)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _extra(self):
        return {"activation": self.activation}

    @staticmethod
    def step(x, states, wi, wh, bi, bh, activation="tanh"):
        (h,) = states
        act = torch.tanh if activation == "tanh" else TF.relu
        out = act(_mm(x, wi) + bi + _mm(h, wh) + bh)
        return out, (out,)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [3 * hidden_size, input_size], weight_ih_attr,
            default_initializer=u)
        self.weight_hh = self.create_parameter(
            [3 * hidden_size, hidden_size], weight_hh_attr,
            default_initializer=u)
        self.bias_ih = self.create_parameter(
            [3 * hidden_size], bias_ih_attr, is_bias=True,
            default_initializer=u)
        self.bias_hh = self.create_parameter(
            [3 * hidden_size], bias_hh_attr, is_bias=True,
            default_initializer=u)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    @staticmethod
    def step(x, states, wi, wh, bi, bh):
        (h,) = states
        hs = wh.shape[1]
        gi = _mm(x, wi) + bi
        gh = _mm(h, wh) + bh
        r = torch.sigmoid(gi[..., :hs] + gh[..., :hs])
        z = torch.sigmoid(gi[..., hs:2 * hs] + gh[..., hs:2 * hs])
        c = torch.tanh(gi[..., 2 * hs:] + r * gh[..., 2 * hs:])
        out = (1 - z) * c + z * h
        return out, (out,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [4 * hidden_size, input_size], weight_ih_attr,
            default_initializer=u)
        self.weight_hh = self.create_parameter(
            [4 * hidden_size, hidden_size], weight_hh_attr,
            default_initializer=u)
        self.bias_ih = self.create_parameter(
            [4 * hidden_size], bias_ih_attr, is_bias=True,
            default_initializer=u)
        self.bias_hh = self.create_parameter(
            [4 * hidden_size], bias_hh_attr, is_bias=True,
            default_initializer=u)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    @staticmethod
    def step(x, states, wi, wh, bi, bh):
        hp, cp = states
        hs = wh.shape[1]
        gates = _mm(x, wi) + bi + _mm(hp, wh) + bh
        i = torch.sigmoid(gates[..., :hs])
        f = torch.sigmoid(gates[..., hs:2 * hs])
        g = torch.tanh(gates[..., 2 * hs:3 * hs])
        o = torch.sigmoid(gates[..., 3 * hs:])
        cn = f * cp + i * g
        hn = o * torch.tanh(cn)
        return hn, (hn, cn)


def _scan(step, x, states, params, extra, time_axis, reverse):
    """The JAX ``lax.scan`` over time: the outputs stacked on
    ``time_axis`` and the final states."""
    xs = x.movedim(time_axis, 0)
    order = range(xs.shape[0] - 1, -1, -1) if reverse else \
        range(xs.shape[0])
    st, outs = tuple(states), [None] * xs.shape[0]
    for t in order:
        outs[t], st = step(xs[t], st, *params, **extra)
        st = tuple(st)
    return torch.stack(outs, time_axis), st


class RNN(Layer):
    """A loop over time around ``cell``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            initial_states = self.cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        single, state_list = _pack(initial_states)
        step, extra = type(self.cell).step, self.cell._extra()
        time_axis, reverse = (0 if self.time_major else 1), self.is_reverse

        def fn(x, st, params):
            return _scan(step, x, st, params, extra, time_axis, reverse)
        outputs, final = cast_call("rnn_scan", fn, inputs, tuple(state_list),
                                   self.cell._params())
        return outputs, (final[0] if single else tuple(final))


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return (manipulation.concat([out_fw, out_bw], axis=-1),
                (st_fw, st_bw))


class _RNNBase(Layer):
    cell_cls = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, **cell_kwargs):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)

        def cell(in_sz):
            return type(self).cell_cls(
                in_sz, hidden_size, weight_ih_attr=attrs[0],
                weight_hh_attr=attrs[1], bias_ih_attr=attrs[2],
                bias_hh_attr=attrs[3], **cell_kwargs)
        layers = []
        for i in range(num_layers):
            in_sz = input_size if i == 0 else \
                hidden_size * self.num_directions
            if self.bidirectional:
                layers.append(BiRNN(cell(in_sz), cell(in_sz), time_major))
            else:
                layers.append(RNN(cell(in_sz), False, time_major))
        self.rnns = LayerList(layers)

    def _split_initial(self, initial_states):
        """Paddle's packed states (``[layers * directions, batch,
        hidden]``; an ``(h, c)`` pair for LSTM) per layer and
        direction."""
        if initial_states is None:
            return [None] * self.num_layers
        if isinstance(initial_states, (tuple, list)):
            hs = manipulation.unstack(initial_states[0], axis=0)
            cs = manipulation.unstack(initial_states[1], axis=0)
            packed = [(h, c) for h, c in zip(hs, cs)]
        else:
            packed = [(h,) for h in manipulation.unstack(initial_states,
                                                         axis=0)]

        def one(st):
            return st if len(st) > 1 else st[0]
        if self.num_directions == 2:
            return [(one(packed[2 * i]), one(packed[2 * i + 1]))
                    for i in range(self.num_layers)]
        return [one(packed[i]) for i in range(self.num_layers)]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        out = inputs
        per_layer = self._split_initial(initial_states)
        final_states = []
        for i, rnn in enumerate(self.rnns):
            out, st = rnn(out, per_layer[i])
            final_states.append(st)
            if self.dropout and i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        return out, final_states


class SimpleRNN(_RNNBase):
    cell_cls = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kwargs)


class GRU(_RNNBase):
    cell_cls = GRUCell


class LSTM(_RNNBase):
    cell_cls = LSTMCell
