"""Speculative decoding: self-drafted n-gram proposals, verified as
extra rows of the engine's paged decode step.

Counterpart of ``paddle2_tpu/serving/spec.py`` (Leviathan et al.,
"Fast Inference from Transformers via Speculative Decoding"). All of it
is host-side Python:

* **Draft**: :func:`ngram_draft` proposes up to ``k`` continuation
  tokens from the sequence's own token log: the newest earlier
  occurrence of the last ``n`` tokens nominates what followed it
  ("prompt lookup" drafting: no draft model, deterministic). A custom
  ``draft_fn`` replaces it (a real draft model, or a test's oracle).
* **Verify**: the engine feeds the pending true token and the drafts as
  extra rows of the same paged decode step. Row ``i`` carries token
  ``i`` of the chunk at position ``p0 + i`` with the sequence's own
  block table, so every row runs the single-query attention a plain
  decode step would: each layer scatters every row's K/V before its
  attention reads them, and each row's context length hides the later
  drafts from it.
* **Accept**: :func:`accept_drafts` keeps drafts while they equal the
  model's own argmax continuation, then the model's next token rides
  along as the bonus. Under greedy decoding the emitted stream is the
  non-speculative one whenever a row's arithmetic does not depend on
  the batch around it. The rejected tail's K/V writes lie past the
  accepted ``num_tokens`` and are overwritten before any later row reads
  them; its surplus blocks go back through ``BlockTable.truncate``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence as Seq, Tuple

__all__ = ["SpeculativeConfig", "ngram_draft", "accept_drafts"]


@dataclass
class SpeculativeConfig:
    """The engine's speculative rounds.

    ``num_draft_tokens`` (k) bounds the chunk a verify round covers
    (``k + 1`` rows a sequence: the engine widens its batch-bucket
    ladder to ``max_batch * (k + 1)``). ``ngram`` is the self-draft
    match length. ``draft_fn(seq) -> List[int]`` replaces the drafter
    (at most ``num_draft_tokens`` proposals; an empty list is a plain
    one-token step for that sequence this round)."""
    num_draft_tokens: int = 3
    ngram: int = 2
    draft_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.num_draft_tokens < 1:
            raise ValueError("num_draft_tokens must be >= 1")
        if self.ngram < 1:
            raise ValueError("ngram must be >= 1")


def ngram_draft(tokens: Seq[int], ngram: int, k: int) -> List[int]:
    """Find the newest earlier occurrence of the trailing ``ngram``
    tokens of ``tokens`` and propose the up to ``k`` tokens that
    followed it. Empty when the log is too short or nothing matches."""
    toks = [int(t) for t in tokens]
    n = len(toks)
    if k < 1 or n <= ngram:
        return []
    pat = toks[-ngram:]
    for j in range(n - ngram - 1, -1, -1):
        if toks[j:j + ngram] == pat:
            return toks[j + ngram:j + ngram + k]
    return []


def accept_drafts(drafts: Seq[int], outs: Seq[int], budget: int
                  ) -> Tuple[List[int], int]:
    """Greedy verify: ``outs[i]`` is the model's argmax after chunk row
    ``i`` (row 0 the pending true token, row ``i >= 1`` ``drafts[i-1]``).
    Drafts are accepted while ``drafts[i] == outs[i]``, then the next
    output rides along as the bonus. ``budget`` caps the tokens emitted
    (accepted + bonus), so a sequence never passes ``max_new_tokens``.
    Returns ``(accepted, bonus)``."""
    if budget < 1:
        raise ValueError("accept budget must be >= 1")
    accepted: List[int] = []
    for i, d in enumerate(drafts):
        if len(accepted) + 1 >= budget:
            break
        if int(d) == int(outs[i]):
            accepted.append(int(d))
        else:
            break
    return accepted, int(outs[len(accepted)])
