"""Containers: the counterpart of ``paddle2_tpu/nn/layer/container.py``
(``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``,
``ParameterDict``), with the JAX package's naming ("0", "1", ... or the
given keys) and indexing."""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable

from .layers import Layer

__all__ = ["ParameterDict", "Sequential", "LayerList", "LayerDict",
           "ParameterList"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, l in layers[0].items():
                self.add_sublayer(name, l)
        else:
            for i, l in enumerate(layers):
                if isinstance(l, tuple):
                    self.add_sublayer(l[0], l[1])
                else:
                    self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        keys = list(self._sub_layers)
        return self._sub_layers[keys[idx]]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def forward(self, input):
        for layer in self._sub_layers.values():
            input = layer(input)
        return input


class LayerList(Layer):
    def __init__(self, sublayers: Iterable[Layer] = None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return self._sub_layers[str(idx % len(self) if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self._sub_layers[str(idx)] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        return self._sub_layers.pop(key)

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(
            sublayers, (dict, OrderedDict, LayerDict)) else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __setitem__(self, idx, param):
        self._parameters[str(idx)] = param

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self


class ParameterDict(Layer):
    """String-keyed parameters."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            for k, v in (parameters.items()
                         if isinstance(parameters, dict) else parameters):
                self.add_parameter(k, v)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, param):
        self.add_parameter(key, param)

    def __len__(self):
        return len(self.named_parameters(include_sublayers=False))

    def __contains__(self, key):
        return any(k == key for k, _ in
                   self.named_parameters(include_sublayers=False))

    def keys(self):
        return [k for k, _ in self.named_parameters(include_sublayers=False)]

    def items(self):
        return self.named_parameters(include_sublayers=False)

    def values(self):
        return [v for _, v in self.named_parameters(include_sublayers=False)]
