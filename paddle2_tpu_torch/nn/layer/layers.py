"""``Layer``, ``ParamAttr`` and ``HookRemoveHelper``: the counterpart of
``paddle2_tpu/nn/layer/layers.py``.

``Layer`` is a ``torch.nn.Module`` (parameters in ``_parameters``,
sublayers in ``_modules``, buffers in ``_buffers``), so the port's
optimizers, ``amp.decorate``, ``jit.train_step``,
``distributed.recompute`` and ``save``/``load`` take it as any module.
On top it carries the JAX ``Layer``'s surface:

- ``parameters()`` and ``named_parameters()`` return lists, in the JAX
  order (each sublayer's own parameters, pre-order, each once);
  torch's keywords (``recurse``, ``remove_duplicate``) are taken too,
  since torch's own code calls them;
- ``state_dict()`` gives the structured names with every parameter
  first, then every persistable buffer, as the JAX package orders them;
  called with torch's keywords (``prefix``, ``keep_vars``, as a torch
  parent module calls it), it is torch's;
- ``set_state_dict`` takes arrays or tensors and returns the missing
  and unexpected keys;
- ``register_buffer(..., persistable=False)`` is torch's non-persistent
  buffer, out of ``state_dict``;
- ``register_forward_pre_hook`` and ``register_forward_post_hook`` are
  torch's forward hooks, whose call convention is the JAX package's
  (``hook(layer, inputs)`` may return new inputs, ``hook(layer, inputs,
  outputs)`` new outputs); they return a :class:`HookRemoveHelper`;
- ``train()`` takes no argument in Paddle, but torch's ``eval()`` calls
  ``train(False)``: both forms work;
- ``apply`` visits the layer before its sublayers, as in JAX.

:meth:`Layer.create_parameter` allocates on the current place
(``framework.core.current_device()``): the card, unless the caller ran
``paddle.set_device("cpu")``. With no GPU and no such call it raises, as
``set_device("gpu")`` does; it never falls back to the CPU.
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ...framework import core
from .. import initializer as I

__all__ = ["Layer", "ParamAttr", "HookRemoveHelper", "ParamBase"]


class ParamAttr:
    """paddle.ParamAttr: the attributes of one parameter."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr()


class ParamBase(torch.nn.Parameter):
    """The parameters ``create_parameter`` makes: ``torch.nn.Parameter``
    whose deep copy keeps the attributes ``ParamAttr`` set on it
    (``need_clip``, ``optimize_attr``, ``regularizer``, ``paddle_name``),
    as a JAX parameter's does; torch's ``Parameter.__deepcopy__`` drops
    them."""

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


class HookRemoveHelper:
    def __init__(self, hooks: dict, hook_id: int):
        self._hooks, self._id = hooks, hook_id

    def remove(self):
        self._hooks.pop(self._id, None)


def _join(prefix: str, name: str) -> str:
    return prefix + ("." if prefix else "") + name


class Layer(torch.nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._dtype = core.convert_dtype(dtype)
        self._full_name = name_scope or self.__class__.__name__.lower()

    @property
    def _sub_layers(self):
        return self._modules

    # -- parameter/buffer management ------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Optional[ParamBase]:
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = core.convert_dtype(dtype) or self._dtype
        init = attr.initializer or default_initializer
        if init is None:
            gw, gb = I.get_global_initializer()
            if is_bias:
                init = gb or I.Constant(0.0)
            else:
                init = gw or I.XavierNormal()
        data = init([int(s) for s in shape], dtype)
        p = ParamBase(data, requires_grad=bool(attr.trainable))
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.need_clip = attr.need_clip
        p.regularizer = attr.regularizer
        if attr.name:
            p.paddle_name = attr.name
        return p

    def add_parameter(self, name: str, parameter):
        if name in self.__dict__:
            del self.__dict__[name]
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        if name in self.__dict__:
            del self.__dict__[name]
        self._modules[name] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        if name in self.__dict__:
            del self.__dict__[name]
        super().register_buffer(name, tensor, persistable)
        return tensor

    # -- traversal -------------------------------------------------------
    def sublayers(self, include_self: bool = False) -> List[torch.nn.Module]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None
                        ) -> Iterator[Tuple[str, torch.nn.Module]]:
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, l in self.named_children():
            sub = _join(prefix, name)
            if isinstance(l, Layer):
                yield from l.named_sublayers(prefix=sub, include_self=True,
                                             layers_set=layers_set)
            elif id(l) not in layers_set:
                for n, m in l.named_modules(prefix=sub):
                    if id(m) not in layers_set:
                        layers_set.add(id(m))
                        yield n, m

    def _layers_for(self, prefix, include_sublayers):
        return (self.named_sublayers(prefix=prefix, include_self=True)
                if include_sublayers else [(prefix, self)])

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         recurse: Optional[bool] = None,
                         remove_duplicate: bool = True
                         ) -> List[Tuple[str, torch.Tensor]]:
        if recurse is not None:
            include_sublayers = recurse
        seen, out = set(), []
        for lpfx, layer in self._layers_for(prefix, include_sublayers):
            for pname, p in layer._parameters.items():
                if p is None or (remove_duplicate and id(p) in seen):
                    continue
                seen.add(id(p))
                out.append((_join(lpfx, pname), p))
        return out

    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None) -> List[torch.Tensor]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      recurse: Optional[bool] = None,
                      remove_duplicate: bool = True
                      ) -> List[Tuple[str, torch.Tensor]]:
        if recurse is not None:
            include_sublayers = recurse
        seen, out = set(), []
        for lpfx, layer in self._layers_for(prefix, include_sublayers):
            for bname, b in layer._buffers.items():
                if b is None or (remove_duplicate and id(b) in seen):
                    continue
                seen.add(id(b))
                out.append((_join(lpfx, bname), b))
        return out

    def buffers(self, include_sublayers: bool = True,
                recurse: Optional[bool] = None) -> List[torch.Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    # -- mode ------------------------------------------------------------
    def apply(self, fn: Callable[[torch.nn.Module], None]) -> "Layer":
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    # -- hooks -----------------------------------------------------------
    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        handle = super().register_forward_pre_hook(hook)
        return HookRemoveHelper(self._forward_pre_hooks, handle.id)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        handle = super().register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, handle.id)

    # -- state dict ------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *, prefix: Optional[str] = None,
                   keep_vars: Optional[bool] = None) -> Dict[str, Any]:
        if prefix is not None or keep_vars is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        dest = destination if destination is not None \
            else collections.OrderedDict()
        top = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=top, include_sublayers=include_sublayers):
            dest[name] = p
        for lpfx, layer in self._layers_for("", include_sublayers):
            skip = getattr(layer, "_non_persistent_buffers_set", ())
            for bname, b in layer._buffers.items():
                if b is None or bname in skip:
                    continue
                dest[_join(top, _join(lpfx, bname))] = b
        return dest

    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for key, target in own.items():
            if key not in state_dict:
                missing.append(key)
                continue
            value = state_dict[key]
            new = value.detach() if isinstance(value, torch.Tensor) \
                else torch.from_numpy(np.array(value))
            if tuple(new.shape) != tuple(target.shape):
                raise ValueError(f"set_state_dict: {key} has shape "
                                 f"{tuple(new.shape)}, the layer's "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(new)
        for key in state_dict:
            if key not in own:
                unexpected.append(key)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype/device ----------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """``to(device, dtype, blocking)`` as in Paddle; a torch dtype
        as the first argument is taken as the dtype, as torch's
        ``Module.to`` takes it. Only floating parameters and buffers
        change dtype."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        kw = {}
        if dtype is not None:
            kw["dtype"] = core.convert_dtype(dtype)
            self._dtype = kw["dtype"]
        if device is not None:
            kw["device"] = core.to_device(device)
        if kw:
            super().to(**kw)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
