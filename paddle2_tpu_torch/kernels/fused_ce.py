"""Fused LM head + softmax cross-entropy, chunked over tokens.

Counterpart of ``paddle2_tpu/kernels/fused_ce.py``. The ``[N, V]`` f32
logits are never held whole: the forward evaluates the head product and
the softmax reduction one chunk of tokens at a time and keeps only each
token's log-sum-exp; the backward recomputes each chunk's logits and
contracts them at once into dx and dW. The JAX package does this at the
XLA level (a ``lax.scan`` over chunks, no Pallas), so the port is
``torch.matmul`` in a Python loop, as an ``autograd.Function``.

The logits and dW come out of their products in f32 from operands in
the input dtype, as the JAX package's ``preferred_element_type=f32``
asks: on a CUDA tensor through ``torch.mm(..., out_dtype=float32)``,
on the CPU (which has no such overload) by taking both operands to f32
first, which gives the same f32 sums of exact products. Softmax, loss
and gradients are f32 from there on; dx is rounded to the input dtype
once, after its f32 sum, as in the JAX package.
"""

import torch

__all__ = ["fused_linear_cross_entropy", "pick_chunk"]

_CHUNKS = (8192, 4096, 2048, 1024, 512, 256)


def pick_chunk(n: int, v: int, device) -> int:
    """Rows per chunk: the largest of 8192, 4096, ..., 256 that divides
    ``n`` and fits the budget, else ``n``. The backward holds three f32
    ``[C, V]`` blocks at once (logits, probabilities, their gradient);
    on a GPU they may take a sixteenth of the card's memory, which on
    an 80 GB H100 at a 32k vocabulary gives 8192 rows (5 GB budget, 3
    GiB used), the whole batch of the training bench in one chunk. On
    the CPU the budget is 1 GiB. (The JAX package's 1 GiB budget was
    measured on a TPU and is not carried over.)"""
    dev = torch.device(device)
    budget = (torch.cuda.get_device_properties(dev).total_memory // 16
              if dev.type == "cuda" else 1 << 30)
    rows = max(_CHUNKS[-1], budget // (3 * 4 * max(v, 1)))
    for c in _CHUNKS:
        if c <= rows and n % c == 0:
            return c
    return n


def _mm_f32(a, b):
    """``a @ b`` as f32 sums of the operands' products (2-D operands of
    one dtype)."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, labels, ignore_index, chunk):
        n = x.shape[0]
        c = chunk or pick_chunk(n, weight.shape[1], x.device)
        losses, lses = [], []
        for i in range(0, n, c):
            logits = _mm_f32(x[i:i + c], weight)             # [C, V] f32
            lc = labels[i:i + c]
            m = logits.amax(-1)
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(-1))
            ok = lc != ignore_index
            safe = torch.where(ok, lc, torch.zeros_like(lc))
            picked = logits.gather(-1, safe[:, None])[:, 0]
            losses.append(torch.where(ok, lse - picked,
                                      torch.zeros_like(lse)))
            lses.append(lse)
        valid = labels != ignore_index
        ctx.save_for_backward(x, weight, labels, torch.cat(lses))
        ctx.ignore_index, ctx.chunk = ignore_index, c
        ctx.mark_non_differentiable(valid)
        return torch.cat(losses), valid

    @staticmethod
    def backward(ctx, g, _dvalid):
        x, weight, labels, lses = ctx.saved_tensors
        c = ctx.chunk
        dx = torch.empty_like(x)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        rows = torch.arange(c, device=x.device)
        for i in range(0, x.shape[0], c):
            xc, lc = x[i:i + c], labels[i:i + c]
            p = torch.exp(_mm_f32(xc, weight) - lses[i:i + c, None])
            ok = lc != ctx.ignore_index
            safe = torch.where(ok, lc, torch.zeros_like(lc))
            p[rows[:xc.shape[0]], safe] -= 1.0               # p - onehot
            dlogits = (p * (g[i:i + c] * ok)[:, None]).to(x.dtype)
            dx[i:i + c] = _mm_f32(dlogits, weight.t())
            dw += _mm_f32(xc.t(), dlogits)
        return dx, dw.to(weight.dtype), None, None, None


def fused_linear_cross_entropy(x, weight, labels, ignore_index: int = -100,
                               chunk=None):
    """Per-token CE loss of ``softmax(x @ weight)`` against ``labels``.

    x: ``[N, H]``; weight: ``[H, V]``; labels: ``[N]`` int. Returns
    ``(losses [N] f32, valid [N] bool)``. Tokens equal to
    ``ignore_index`` contribute zero loss and zero gradient. ``chunk``
    rows per chunk (it must divide N) or None for :func:`pick_chunk`."""
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[0]:
        raise ValueError(f"need x [N, H] and weight [H, V], got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if chunk is not None and x.shape[0] % chunk:
        raise ValueError(f"chunk {chunk} does not divide {x.shape[0]}")
    return _FusedLinearCE.apply(x, weight, labels.long(), int(ignore_index),
                                chunk)
