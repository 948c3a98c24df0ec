"""``paddle2_tpu_torch.nn``'s ``BeamSearchDecoder`` and
``dynamic_decode`` against the JAX package's on the CPU: an LSTM cell
decoder with the JAX weights gives the same ids and lengths (batch-major
and time-major, ``return_length``, stopped by ``max_step_num`` or by
every beam finishing); logits built with ties give the same ids, ties
going to the lower flat index as ``lax.top_k`` orders them; and the
initial state of the search."""

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.models import nn_state_from_reference
from torch_core_harness import port_on_cpu  # noqa: F401

V, H, BEAM = 12, 8, 4


def _decoder_parts(pkg):
    class Parts(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pkg.nn.Embedding(V, H)
            self.cell = pkg.nn.LSTMCell(H, H)
            self.out = pkg.nn.Linear(H, V)
    return Parts()


def _twins():
    jp.seed(3)
    j = _decoder_parts(jp)
    t = _decoder_parts(tp)
    t.set_state_dict(nn_state_from_reference(j))
    return j, t


def _decode(pkg, parts, h0, c0, **kw):
    dec = pkg.nn.BeamSearchDecoder(parts.cell, start_token=0, end_token=1,
                                   beam_size=BEAM, embedding_fn=parts.emb,
                                   output_fn=parts.out)
    return pkg.nn.dynamic_decode(dec, inits=(h0, c0), return_length=True,
                                 **kw)


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


@pytest.mark.parametrize("max_step_num,time_major", [(6, False), (None, False),
                                                     (9, True)])
def test_beam_search_ids_and_lengths_match_jax(max_step_num, time_major):
    j, t = _twins()
    rng = np.random.default_rng(4)
    h0 = rng.standard_normal((3, H)).astype(np.float32)
    c0 = rng.standard_normal((3, H)).astype(np.float32)
    jids, jlen = _decode(jp, j, jp.to_tensor(h0), jp.to_tensor(c0),
                         max_step_num=max_step_num,
                         output_time_major=time_major)
    tids, tlen = _decode(tp, t, torch.from_numpy(h0), torch.from_numpy(c0),
                         max_step_num=max_step_num,
                         output_time_major=time_major)
    assert tids.dtype == torch.int32 and tlen.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), _np(jids))
    np.testing.assert_array_equal(tlen.numpy(), _np(jlen))
    if max_step_num is None:
        # every beam finished before 256 steps
        assert tids.shape[1] < 256


class _TieCell:
    """A cell whose logits tie: every row the same vector with equal
    entries, the end token among the best for some rows."""

    def __init__(self, pkg, logits):
        self.pkg, self.logits = pkg, logits

    def __call__(self, inputs, states):
        n = inputs.shape[0]
        row = np.broadcast_to(self.logits, (n, V)).copy()
        if self.pkg is jp:
            return jp.to_tensor(row), states
        return torch.from_numpy(row), states


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ties_go_to_the_lower_flat_index(seed):
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 3, size=V).astype(np.float32)
    h0 = np.zeros((2, 3), np.float32)
    out = []
    for pkg, ten in ((jp, jp.to_tensor), (tp, torch.from_numpy)):
        dec = pkg.nn.BeamSearchDecoder(_TieCell(pkg, logits), 0, 1, BEAM)
        ids, lens = pkg.nn.dynamic_decode(dec, inits=ten(h0),
                                          max_step_num=5,
                                          return_length=True)
        out.append((_np(ids), _np(lens)))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])


def test_initialize_starts_one_live_beam():
    dec = tp.nn.BeamSearchDecoder(None, start_token=5, end_token=1,
                                  beam_size=3)
    tokens, states, log_probs, finished = dec.initialize(
        (torch.ones(2, 4), torch.zeros(2, 4)))
    assert tokens.dtype == torch.int32 and tokens.tolist() == [5] * 6
    assert states[0].shape == (6, 4)
    assert log_probs.tolist() == [[0.0, -1e9, -1e9]] * 2
    assert not finished.any() and finished.shape == (2, 3)
    x = torch.arange(6).reshape(2, 3)
    assert tp.nn.BeamSearchDecoder.tile_beam_merge_with_batch(
        x, 2).tolist() == [[0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]]
