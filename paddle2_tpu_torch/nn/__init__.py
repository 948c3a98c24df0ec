"""Neural-network layers of the port: only what the GPT model needs
beyond ``torch.nn`` so far (the rest is ROADMAP queue 1 item 2)."""

from .norm import LayerNorm

__all__ = ["LayerNorm"]
