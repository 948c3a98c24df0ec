"""Seq2seq decoding: the counterpart of ``paddle2_tpu/nn/decode.py``
(``Decoder``, ``BeamSearchDecoder``, ``dynamic_decode``).

The step loop runs on the host, as in the JAX package (a decode's
length depends on the data); each step's tensor work runs on the
states' device. States are nested tuples, lists or dicts, mapped with
``torch.utils._pytree``. The rules carried over:

- ``initialize`` tiles the states across the beams and starts beam 0 at
  log-probability 0 and the others at -1e9, with int32 start tokens;
- a finished beam extends only by ``end_token``, at cost 0;
- of the ``beam * V`` candidates of a batch row the best ``beam_size``
  are taken, ``parent = idx // V`` and ``token = idx % V``. Ties go to
  the lower flat index, as ``lax.top_k`` orders them, by a stable
  descending sort (``torch.topk`` promises no order among ties on the
  card). Ties are common: -1e9 absorbs any f32 log-probability added to
  it, so every candidate of a dead or finished beam but ``end_token``
  scores the same;
- ``dynamic_decode`` stops when every beam has finished or at
  ``max_step_num`` steps (256 when None), backtraces with
  ``gather_tree``, and counts ``end_token`` in the lengths (+1, capped
  at the step count).
"""

import torch
from torch.utils import _pytree as pytree

from .functional.extra_losses import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


class Decoder:
    """The ``initialize`` / ``step`` / ``finalize`` protocol."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over an RNN cell: ``embedding_fn`` maps token ids to
    the cell's input, ``output_fn`` the cell's output to vocabulary
    logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[B, ...]`` -> ``[B * beam, ...]``, each row repeated."""
        return x.repeat_interleave(beam_size, 0)

    def _merge(self, a):
        return a.reshape((-1,) + tuple(a.shape[2:]))

    def _split(self, a):
        return a.reshape((-1, self.beam_size) + tuple(a.shape[1:]))

    def initialize(self, inits):
        states = pytree.tree_map(
            lambda t: t.repeat_interleave(self.beam_size, 0), inits)
        first = pytree.tree_leaves(states)[0]
        batch, dev = first.shape[0] // self.beam_size, first.device
        tokens = torch.full((batch * self.beam_size,), self.start_token,
                            dtype=torch.int32, device=dev)
        log_probs = torch.tensor([0.0] + [-1e9] * (self.beam_size - 1),
                                 dtype=torch.float32,
                                 device=dev)[None].repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return tokens, states, log_probs, finished

    def _embed(self, tokens):
        if self.embedding_fn is not None:
            return self.embedding_fn(tokens)
        return tokens

    def _scores(self, logits, log_probs, finished):
        """``[B, beam * V]``: each candidate's log-probability, a
        finished beam's only by ``end_token`` at cost 0."""
        V = logits.shape[-1]
        B = logits.shape[0] // self.beam_size
        step_lp = torch.log_softmax(logits.float(), -1)
        step_lp = step_lp.reshape(B, self.beam_size, V)
        fin_mask = torch.full((V,), -1e9, dtype=torch.float32,
                              device=step_lp.device)
        fin_mask[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], fin_mask[None, None],
                              step_lp)
        return (log_probs[..., None] + step_lp).reshape(B, -1)

    def step(self, time, tokens, states, log_probs, finished):
        cell_out, next_states = self.cell(self._embed(tokens), states)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        V = cell_out.shape[-1]
        B = cell_out.shape[0] // self.beam_size
        scores = self._scores(cell_out, log_probs, finished)
        ordered, idx = torch.sort(scores, dim=-1, descending=True,
                                  stable=True)
        top_scores = ordered[:, :self.beam_size]
        top_idx = idx[:, :self.beam_size]
        parent = (top_idx // V).to(torch.int32)            # [B, beam]
        token = (top_idx % V).to(torch.int32)

        def reorder(t):
            s = self._split(t)
            ix = parent.long().reshape(
                (B, self.beam_size) + (1,) * (s.ndim - 2)).expand(s.shape)
            return self._merge(s.gather(1, ix))
        next_states = pytree.tree_map(reorder, next_states)
        prev_fin = finished.gather(1, parent.long())
        next_finished = prev_fin | (token == self.end_token)
        return (token.reshape(-1), next_states, top_scores, next_finished,
                parent)

    def finalize(self, step_tokens, step_parents, sequence_lengths):
        """The beams backtraced through their parents."""
        return gather_tree(torch.stack(step_tokens),
                           torch.stack(step_parents))


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """``decoder.initialize``, then steps until every beam has finished or
    ``max_step_num``; ``decoder.finalize`` backtraces."""
    tokens, states, log_probs, finished = decoder.initialize(inits)
    B, beam = finished.shape
    step_tokens, step_parents = [], []
    lengths = torch.zeros((B, beam), dtype=torch.int32,
                          device=finished.device)
    limit = int(max_step_num) if max_step_num is not None else 256
    for t in range(limit):
        tokens, states, log_probs, next_finished, parent = decoder.step(
            t, tokens, states, log_probs, finished)
        step_tokens.append(tokens.reshape(B, beam))
        step_parents.append(parent)
        lengths = lengths + (~next_finished).to(torch.int32)
        finished = next_finished
        if bool(finished.all()):
            break
    ids = decoder.finalize(step_tokens, step_parents, lengths)
    if not output_time_major:
        ids = ids.permute(1, 0, 2)
    lengths = torch.clamp(lengths + 1, max=len(step_tokens))
    if return_length:
        return ids, lengths
    return ids
