"""Shared helpers of the model zoo: the counterpart of
``paddle2_tpu/vision/models/_utils.py``."""


def no_pretrained(pretrained):
    """The port downloads nothing: ``pretrained=True`` raises. Load
    weights with ``paddle.load`` and ``set_state_dict`` (a JAX
    package's checkpoint loads as it is)."""
    if pretrained:
        raise ValueError(
            "pretrained=True is unavailable offline; use paddle.load + "
            "set_state_dict with a local weights file")
