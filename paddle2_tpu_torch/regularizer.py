"""``paddle.regularizer``: the counterpart of
``paddle2_tpu/regularizer.py``. ``L1Decay`` and ``L2Decay`` are markers
an optimizer's ``weight_decay`` takes: it reads ``_coeff`` and the
class name (``Optimizer._wd_value``) and folds ``coeff * sign(p)`` or
``coeff * p`` into the gradient (decoupled for AdamW and Lion)."""

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
