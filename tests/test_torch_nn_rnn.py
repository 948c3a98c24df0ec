"""``paddle2_tpu_torch.nn``'s recurrent layers against
``paddle2_tpu.nn``'s on the CPU, from the same weights
(``nn_state_from_reference``): every ``RNN_LAYERS`` entry of
``torch_nn_table_spatial_rnn`` (the cells, the multi-layer and
bidirectional ``SimpleRNN``/``GRU``/``LSTM``, ``time_major``, packed
initial states, dropout in eval mode; forward, final states and the
gradients of every float input and parameter), ``RNN`` and ``BiRNN``
around cells with ``is_reverse``, the final states as a list per layer,
and the dtypes: a bf16-decorated ``LSTM`` meets f32 initial states
outside ``auto_cast`` and promotes to f32 as JAX does, O2 casts them,
and O1 casts ``rnn_scan`` but not a bare cell (``"LSTMCell"``)."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.models import nn_state_from_reference
from torch_core_cases import TOL, assert_same
from torch_core_harness import port_on_cpu  # noqa: F401
from torch_nn_layer_harness import layer_params, run_layer
from torch_nn_table_spatial_rnn import PROMOTED, RNN_BF16, RNN_LAYERS


@pytest.mark.parametrize("entry,dtype", layer_params(RNN_LAYERS))
def test_rnn_layer_matches_jax(entry, dtype):
    run_layer(entry, dtype)


def _twins(make):
    """``make(pkg)`` in both packages, the JAX weights in the port's."""
    jp.seed(0)
    jl = make(jp)
    tl = make(tp)
    missing, unexpected = tl.set_state_dict(nn_state_from_reference(jl))
    assert not missing and not unexpected
    assert list(tl.state_dict()) == list(jl.state_dict())
    return jl, tl


def _seq(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grads_match(jout, tout, jl, tl, tol=TOL):
    """Forward and every parameter gradient of ``sum(out * cot)``."""
    assert_same(tout, jout, tol, "forward")
    cot = _seq(tuple(jout.shape), 1)
    jparams = list(jl.parameters())
    jg = jp.grad([(jout * jp.to_tensor(cot)).sum()], jparams)
    tg = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                             list(tl.parameters()))
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert_same(a, b, tol, f"grad {i}")


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "GRUCell", "LSTMCell"])
@pytest.mark.parametrize("reverse,time_major", [(False, False),
                                                (True, False),
                                                (True, True)])
def test_rnn_around_a_cell(cell, reverse, time_major):
    jl, tl = _twins(lambda pkg: pkg.nn.RNN(getattr(pkg.nn, cell)(4, 5),
                                           is_reverse=reverse,
                                           time_major=time_major))
    x = _seq((6, 3, 4) if time_major else (3, 6, 4))
    jout, jst = jl(jp.to_tensor(x))
    tout, tst = tl(torch.from_numpy(x))
    assert_same(tst, jst, TOL, "final states")
    assert isinstance(tst, tuple) == (cell == "LSTMCell")
    _grads_match(jout, tout, jl, tl)


def test_birnn_concatenates_directions():
    jl, tl = _twins(lambda pkg: pkg.nn.BiRNN(pkg.nn.LSTMCell(4, 5),
                                             pkg.nn.LSTMCell(4, 5)))
    x = _seq((3, 6, 4))
    h0 = [_seq((3, 5), s) for s in (2, 3, 4, 5)]
    jinit = ((jp.to_tensor(h0[0]), jp.to_tensor(h0[1])),
             (jp.to_tensor(h0[2]), jp.to_tensor(h0[3])))
    tinit = ((torch.from_numpy(h0[0]), torch.from_numpy(h0[1])),
             (torch.from_numpy(h0[2]), torch.from_numpy(h0[3])))
    jout, jst = jl(jp.to_tensor(x), jinit)
    tout, tst = tl(torch.from_numpy(x), tinit)
    assert tuple(tout.shape) == (3, 6, 10)
    assert_same(tst, jst, TOL, "final states")
    _grads_match(jout, tout, jl, tl)


def test_final_states_are_a_list_per_layer():
    jl, tl = _twins(lambda pkg: pkg.nn.LSTM(4, 5, num_layers=3,
                                            direction="bidirect"))
    x = _seq((2, 4, 4))
    _, jst = jl(jp.to_tensor(x))
    _, tst = tl(torch.from_numpy(x))
    assert isinstance(jst, list) and isinstance(tst, list)
    assert len(tst) == len(jst) == 3
    # each layer: (forward (h, c), backward (h, c))
    assert all(len(s) == 2 and len(s[0]) == 2 for s in tst)
    assert_same(tst, jst, TOL, "final states")


def test_sequence_length_is_ignored():
    jl, tl = _twins(lambda pkg: pkg.nn.GRU(4, 5))
    x = _seq((3, 6, 4))
    lens = np.array([6, 2, 4], np.int32)
    jout, _ = jl(jp.to_tensor(x), sequence_length=jp.to_tensor(lens))
    tout, _ = tl(torch.from_numpy(x), sequence_length=torch.from_numpy(lens))
    assert_same(tout, jout, TOL, "forward")
    assert torch.equal(tout, tl(torch.from_numpy(x))[0])


def _decorated_lstm():
    jl, tl = _twins(lambda pkg: pkg.nn.LSTM(4, 6, num_layers=2))
    jl = jp.amp.decorate(jl, level="O2", dtype="bfloat16")
    tl = tp.amp.decorate(tl, level="O2", dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tl.parameters())
    return jl, tl


def test_bf16_lstm_promotes_f32_states_outside_auto_cast():
    """O2-decorated parameters, bf16 input, f32 initial states (the
    default ``get_initial_states``), no ``auto_cast``: the recurrent
    products and gates promote to f32 in JAX, and so in the port."""
    jl, tl = _decorated_lstm()
    x = _seq((3, 5, 4))
    jout, jst = jl(jp.to_tensor(x).astype("bfloat16"))
    tout, tst = tl(torch.from_numpy(x).bfloat16())
    assert str(jout.dtype).endswith("float32")
    assert tout.dtype == torch.float32
    assert all(s.dtype == torch.float32 for st in tst for s in st)
    assert_same((tout, tst), (jout, jst), PROMOTED, "promoted")


def test_bf16_lstm_under_o2_casts_the_states():
    jl, tl = _decorated_lstm()
    x = _seq((3, 5, 4))
    with jp.amp.auto_cast(level="O2", dtype="bfloat16"):
        jout, jst = jl(jp.to_tensor(x))
    with tp.amp.auto_cast(level="O2", dtype="bfloat16"):
        tout, tst = tl(torch.from_numpy(x))
    assert tout.dtype == torch.bfloat16
    assert_same((tout, tst), (jout, jst), RNN_BF16, "O2")


def test_o1_casts_rnn_scan_and_not_a_bare_cell():
    """``rnn_scan`` is on the white list; a bare cell's op name is its
    class name, which no list names."""
    jr, tr = _twins(lambda pkg: pkg.nn.RNN(pkg.nn.LSTMCell(4, 6)))
    jc, tc = _twins(lambda pkg: pkg.nn.LSTMCell(4, 6))
    x = _seq((3, 5, 4))
    with jp.amp.auto_cast(level="O1", dtype="bfloat16"):
        jseq, _ = jr(jp.to_tensor(x))
        jcell, _ = jc(jp.to_tensor(x[:, 0]))
    with tp.amp.auto_cast(level="O1", dtype="bfloat16"), \
            tp.amp.record_casts() as rec:
        tseq, _ = tr(torch.from_numpy(x))
        tcell, _ = tc(torch.from_numpy(x[:, 0]))
    assert str(jseq.dtype).endswith("bfloat16")
    assert str(jcell.dtype).endswith("float32")
    assert (tseq.dtype, tcell.dtype) == (torch.bfloat16, torch.float32)
    assert [name for name, _ in rec] == ["rnn_scan"]
    assert_same(tseq, jseq, RNN_BF16, "O1 scan")
    assert_same(tcell, jcell, TOL, "O1 cell")


def test_dropout_between_layers_in_training():
    """Dropout reaches the outputs of every layer but the last: a
    one-layer LSTM in training is deterministic, a two-layer one is not
    (and is again at ``dropout=0``)."""
    x = torch.from_numpy(_seq((3, 5, 4)))
    one = tp.nn.LSTM(4, 6, num_layers=1, dropout=0.5)
    assert torch.equal(one(x)[0], one(x)[0])
    two = tp.nn.LSTM(4, 6, num_layers=2, dropout=0.5)
    assert not torch.equal(two(x)[0], two(x)[0])
    two.eval()
    assert torch.equal(two(x)[0], two(x)[0])
