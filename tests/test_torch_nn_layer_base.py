"""``paddle2_tpu_torch.nn.Layer``, ``ParamAttr``, ``create_parameter``,
the initializers and the containers against the JAX package's on the
CPU: the surface (every name of this slice's JAX modules, in order),
parameter creation and its attributes, global initializers, hooks,
modes, traversal, state dicts, devices, dtype casts and AMP's O2 norm
set. The initializers' random draws are held by their statistics (the
port draws from torch generators, JAX from its keys); ``Constant``,
``Assign``, ``Dirac``, ``Bilinear`` and ``calculate_gain`` exactly."""

import collections
import copy
import importlib
import math

import numpy as np
import pytest
import torch

import paddle2_tpu as jp
import paddle2_tpu_torch as tp
from paddle2_tpu_torch.framework import core
from torch_core_harness import port_on_cpu  # noqa: F401

JI, TI = jp.nn.initializer, tp.nn.initializer
LAYER_MODULES = ("activation", "common", "container", "norm", "loss",
                 "transformer")


# ------------------------------------------------------------- surface
@pytest.mark.parametrize("mod", LAYER_MODULES)
def test_layer_modules_export_the_jax_names_in_order(mod):
    jm = importlib.import_module(f"paddle2_tpu.nn.layer.{mod}")
    tm = importlib.import_module(f"paddle2_tpu_torch.nn.layer.{mod}")
    assert tm.__all__ == jm.__all__
    for name in jm.__all__:
        assert getattr(tp.nn, name) is getattr(tm, name), name
        assert name in tp.nn.__all__, name


def test_nn_namespace_keeps_the_jax_order():
    want = ["initializer", "Layer", "ParamAttr", "functional"]
    for mod in ("common", "norm", "activation", "container", "transformer",
                "loss"):
        want += importlib.import_module(f"paddle2_tpu.nn.layer.{mod}").__all__
    order = [tp.nn.__all__.index(n) for n in want]
    assert order == sorted(order)
    assert TI.__all__ == JI.__all__
    assert tp.ParamAttr is tp.nn.ParamAttr
    assert callable(tp.create_parameter)
    assert "create_parameter" in tp.ops.misc.__all__


# ------------------------------------------- parameters and ParamAttr
def test_create_parameter_defaults_and_attr_false():
    layer = tp.nn.Layer()
    w = layer.create_parameter([3, 4])
    b = layer.create_parameter([4], is_bias=True)
    assert isinstance(w, torch.nn.Parameter) and w.requires_grad
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    assert torch.equal(b, torch.zeros(4))
    assert layer.create_parameter([2], attr=False) is None
    assert tp.create_parameter([2, 3], "bfloat16").dtype == torch.bfloat16
    assert tp.create_parameter([2], "float32", attr=False) is None
    assert tp.nn.Layer(dtype="bfloat16").create_parameter([2]).dtype == \
        torch.bfloat16


def test_param_attr_fields_are_set_as_jax_sets_them():
    reg = tp.regularizer.L2Decay(0.1)
    attr = tp.ParamAttr(name="w0", initializer=TI.Constant(0.5),
                        learning_rate=0.3, regularizer=reg, trainable=False,
                        need_clip=False)
    p = tp.create_parameter([2, 2], "float32", attr=attr)
    jattr = jp.ParamAttr(name="w0", initializer=JI.Constant(0.5),
                         learning_rate=0.3, trainable=False, need_clip=False)
    jpar = jp.create_parameter([2, 2], "float32", attr=jattr)
    np.testing.assert_array_equal(p.detach().numpy(),
                                  np.asarray(jpar.numpy()))
    assert p.requires_grad is False and jpar.stop_gradient is True
    assert p.optimize_attr == jpar.optimize_attr == {"learning_rate": 0.3}
    assert p.need_clip is False and jpar.need_clip is False
    assert p.regularizer is reg
    assert p.paddle_name == "w0"
    # a deep copy keeps them (torch's Parameter copy drops attributes)
    q = copy.deepcopy(p)
    assert (q.need_clip, q.optimize_attr, q.paddle_name) == \
        (False, {"learning_rate": 0.3}, "w0")
    # an initializer or a name stands for a ParamAttr
    assert torch.equal(tp.create_parameter([3], "float32",
                                           attr=TI.Constant(2.0)),
                       torch.full((3,), 2.0))
    assert tp.create_parameter([3], "float32", attr="b").paddle_name == "b"


def test_need_clip_false_is_left_out_of_the_global_norm():
    lin = tp.nn.Linear(4, 3, weight_attr=tp.ParamAttr(need_clip=False))
    for p in lin.parameters():
        p.grad = torch.full_like(p, 10.0)
    clip = tp.nn.ClipGradByGlobalNorm(1.0)
    out = dict(clip([(p, p.grad) for p in lin.parameters()]))
    assert torch.equal(out[lin.weight], torch.full((4, 3), 10.0))
    np.testing.assert_allclose(out[lin.bias].norm().item(), 1.0, rtol=1e-6)


def test_global_initializer_is_read_by_create_parameter():
    try:
        TI.set_global_initializer(TI.Constant(0.3), TI.Constant(0.7))
        JI.set_global_initializer(JI.Constant(0.3), JI.Constant(0.7))
        t, j = tp.nn.Bilinear(2, 3, 4), jp.nn.Bilinear(2, 3, 4)
        for (n, a), (m, b) in zip(t.named_parameters(),
                                  j.named_parameters()):
            assert n == m
            np.testing.assert_array_equal(a.detach().numpy(),
                                          np.asarray(b.numpy()))
        assert torch.equal(t.bias, torch.full((4,), 0.7))
        # a layer's own default initializer wins over the global one
        assert torch.equal(tp.nn.Linear(2, 3).bias, torch.zeros(3))
    finally:
        TI.set_global_initializer(None, None)
        JI.set_global_initializer(None, None)


def test_parameters_land_on_the_current_place_and_never_fall_back():
    assert tp.nn.Linear(2, 3).weight.device.type == "cpu"
    before = core._current_place
    core._current_place = None      # a fresh process: the card
    try:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default place is taken")
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.nn.Linear(2, 3)
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.create_parameter([2], "float32")
    finally:
        core._current_place = before


# -------------------------------------------------------------- hooks
def test_forward_hooks_follow_the_jax_semantics():
    jp.seed(0)
    jl = jp.nn.Linear(3, 2)
    tl = tp.nn.Linear(3, 2)
    tl.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jl.state_dict().items()})
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    outs = []
    for layer, tensor in ((jl, jp.to_tensor), (tl, torch.from_numpy)):
        seen = []
        pre = layer.register_forward_pre_hook(
            lambda l, inputs: (inputs[0] * 2,))
        post = layer.register_forward_post_hook(
            lambda l, inputs, out: seen.append(inputs[0]) or out + 1)
        a = layer(tensor(x))
        pre.remove()
        b = layer(tensor(x))
        post.remove()
        c = layer(tensor(x))
        outs.append([np.asarray(t.detach().numpy() if hasattr(t, "detach")
                                else t.numpy()) for t in (a, b, c)])
        np.testing.assert_array_equal(np.asarray(
            seen[0].numpy() if not hasattr(seen[0], "detach")
            else seen[0].detach().numpy()), 2 * x)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert isinstance(pre, tp.nn.layer.layers.HookRemoveHelper)


# ---------------------------------------------- modes and traversal
def _pair(make):
    jp.seed(0)
    return make(jp.nn), make(tp.nn)


def _tiny(nn):
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                         nn.LayerList([nn.Linear(8, 8), nn.BatchNorm1D(8)]),
                         nn.Dropout(0.1))


def test_train_and_eval_reach_every_sublayer():
    j, t = _pair(_tiny)
    for layer in (j, t):
        assert layer.eval() is layer
        assert not any(s.training for s in layer.sublayers(True))
        assert layer.train() is layer
        assert all(s.training for s in layer.sublayers(True))
    t.train(False)                  # torch's form, which eval() uses
    assert not any(s.training for s in t.sublayers(True))


def test_traversal_names_and_order_match_jax():
    j, t = _pair(_tiny)
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    assert isinstance(t.parameters(), list)
    assert isinstance(t.named_parameters(), list)
    assert [n for n, _ in t.named_buffers()] == \
        [n for n, _ in j.named_buffers()]
    assert list(t.state_dict()) == list(j.state_dict())
    assert [type(c).__name__ for c in t.children()] == \
        [type(c).__name__ for c in j.children()]
    jv, tv = [], []
    j.apply(lambda l: jv.append(type(l).__name__))
    t.apply(lambda l: tv.append(type(l).__name__))
    assert tv == jv and tv[0] == "Sequential"
    assert t.full_name() == j.full_name() == "sequential"
    assert t.parameters(include_sublayers=False) == []


def test_add_parameter_sublayer_and_buffers():
    j, t = _pair(lambda nn: nn.Layer())
    for layer, xp in ((j, jp), (t, tp)):
        layer.add_parameter("w", xp.create_parameter([2], "float32"))
        layer.add_sublayer("sub", (jp if xp is jp else tp).nn.Linear(2, 2))
        layer.register_buffer("kept", xp.to_tensor(np.ones(2, np.float32)))
        layer.register_buffer("scratch",
                              xp.to_tensor(np.zeros(2, np.float32)),
                              persistable=False)
    assert list(t.state_dict()) == list(j.state_dict()) == \
        ["w", "sub.weight", "sub.bias", "kept"]
    assert [n for n, _ in t.named_buffers()] == ["kept", "scratch"]
    t.clear_gradients()
    assert all(p.grad is None for p in t.parameters())


def test_set_state_dict_reports_missing_and_unexpected_keys():
    j, t = _pair(lambda nn: nn.Linear(3, 2))
    state = {"weight": np.ones((3, 2), np.float32),
             "extra": np.zeros(1, np.float32)}
    assert t.set_state_dict(state) == j.set_state_dict(
        {k: jp.to_tensor(v) for k, v in state.items()}) == \
        (["bias"], ["extra"])
    assert torch.equal(t.weight, torch.ones(3, 2))
    assert t.set_state_dict({"weight": torch.zeros(3, 2)}) == (["bias"], [])
    with pytest.raises(ValueError, match="shape"):
        t.set_state_dict({"weight": np.zeros((2, 3), np.float32)})


def test_a_torch_parent_saves_a_layer_under_torch_names():
    parent = torch.nn.Module()
    parent.add_module("ln", tp.nn.LayerNorm(4))
    parent.add_module("net", tp.nn.Sequential(tp.nn.Linear(2, 2)))
    assert list(parent.state_dict()) == ["ln.weight", "ln.bias",
                                         "net.0.weight", "net.0.bias"]
    parent.load_state_dict(parent.state_dict())


def test_dtype_casts_touch_floating_state_only():
    j, t = _pair(lambda nn: nn.Sequential(nn.Linear(2, 3),
                                          nn.BatchNorm1D(3)))
    for layer in (j, t):
        layer.to(dtype="bfloat16")
    assert [str(p.dtype).rpartition(".")[2] for p in t.parameters()] == \
        [str(p.dtype).rpartition(".")[2] for p in j.parameters()]
    assert t._dtype == torch.bfloat16
    assert t.float()[0].weight.dtype == torch.float32
    assert t.bfloat16()[0].weight.dtype == torch.bfloat16
    assert t.astype("float32")[1]._mean.dtype == torch.float32
    assert t.to(torch.float32) is t
    assert t.to("cpu")[0].weight.device.type == "cpu"


# ----------------------------------------------------------- containers
def test_layer_list_dict_and_sequential_behave_as_in_jax():
    j, t = _pair(lambda nn: nn.LayerList([nn.Linear(2, 2) for _ in
                                          range(3)]))
    for layer, nn in ((j, jp.nn), (t, tp.nn)):
        layer.append(nn.ReLU())
        layer.insert(1, nn.Tanh())
        layer.extend([nn.Sigmoid()])
        assert len(layer) == 6
        assert type(layer[-1]).__name__ == "Sigmoid"
        assert type(layer[1]).__name__ == "Tanh"
        assert len(layer[1:3]) == 2
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]
    assert list(t.state_dict()) == list(j.state_dict())
    jd, td = _pair(lambda nn: nn.LayerDict(collections.OrderedDict(
        [("a", nn.Linear(2, 2)), ("b", nn.ReLU())])))
    for d in (jd, td):
        assert list(d.keys()) == ["a", "b"] and "a" in d and len(d) == 2
        d.pop("b")
        assert list(d) == ["a"]
    assert list(td.state_dict()) == list(jd.state_dict())
    js, ts = _pair(lambda nn: nn.Sequential(
        collections.OrderedDict([("fc", nn.Linear(2, 3)),
                                 ("act", nn.ReLU())])))
    assert list(ts.state_dict()) == list(js.state_dict()) == \
        ["fc.weight", "fc.bias"]
    assert type(ts[-1]).__name__ == "ReLU" and len(ts[:1]) == 1
    x = np.ones((1, 2), np.float32)
    ts.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in js.state_dict().items()})
    np.testing.assert_allclose(ts(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(js(jp.to_tensor(x)).numpy()),
                               rtol=1e-6)


def test_parameter_list_and_dict():
    j = jp.nn.ParameterList([jp.create_parameter([2], "float32")
                             for _ in range(2)])
    t = tp.nn.ParameterList([tp.create_parameter([2], "float32")
                             for _ in range(2)])
    j.append(jp.create_parameter([3], "float32"))
    t.append(tp.create_parameter([3], "float32"))
    assert list(t.state_dict()) == list(j.state_dict()) == ["0", "1", "2"]
    assert len(t) == 3 and tuple(t[2].shape) == (3,)
    td = tp.nn.ParameterDict({"x": tp.create_parameter([2], "float32")})
    td["y"] = tp.create_parameter([1], "float32")
    assert td.keys() == ["x", "y"] and "y" in td and len(td) == 2
    assert td["y"] is td.values()[1]


def test_sync_batch_norm_converts_a_tree():
    net = tp.nn.Sequential(tp.nn.Linear(2, 3), tp.nn.BatchNorm1D(3))
    with torch.no_grad():
        net[1]._mean.fill_(0.5)
    out = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], tp.nn.SyncBatchNorm)
    assert torch.equal(out[1]._mean, torch.full((3,), 0.5))


# ----------------------------------------------------------------- AMP
def test_o2_keeps_the_jax_norm_set_in_float32():
    """BatchNorm, LayerNorm, GroupNorm and RMSNorm keep f32 parameters at
    O2; an instance norm and the rest are cast, as in the JAX package."""
    def make(nn):
        return nn.Sequential(nn.Linear(4, 4), nn.LayerNorm(4),
                             nn.BatchNorm1D(4), nn.GroupNorm(2, 4),
                             nn.RMSNorm(4), nn.InstanceNorm1D(4),
                             nn.PReLU())
    j, t = _pair(make)
    jp.amp.decorate(j, level="O2", dtype="bfloat16")
    tp.amp.decorate(t, level="O2", dtype="bfloat16")
    jd = [(n, str(p.dtype).rpartition(".")[2])
          for n, p in j.named_parameters()]
    td = [(n, str(p.dtype).rpartition(".")[2])
          for n, p in t.named_parameters()]
    assert td == jd
    assert dict(td)["5.weight"] == "bfloat16"
    assert dict(td)["1.weight"] == "float32"


@pytest.mark.parametrize("fn,args", [
    ("linear", ((2, 3), (3, 4))), ("softmax", ((2, 3),)),
    ("gelu", ((2, 3),)), ("rms_norm", ((2, 3),)),
    ("mse_loss", ((2, 3), (2, 3))), ("cosine_similarity", ((2, 3), (2, 3)))])
def test_functionals_cast_by_their_jax_names_under_auto_cast(fn, args):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in args]
    with jp.amp.auto_cast(level="O1", dtype="bfloat16"):
        jo = getattr(jp.nn.functional, fn)(*[jp.to_tensor(a)
                                             for a in arrays])
    with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
        to = getattr(tp.nn.functional, fn)(*[torch.from_numpy(a)
                                             for a in arrays])
    assert str(to.dtype).rpartition(".")[2] == \
        str(jo.dtype).rpartition(".")[2]


# --------------------------------------------------------- initializers
@pytest.mark.parametrize("nl,param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("leaky_relu", None), ("leaky_relu", 0.2),
    ("selu", None), ("conv3d_transpose", None)])
def test_calculate_gain_is_exact(nl, param):
    assert TI.calculate_gain(nl, param) == JI.calculate_gain(nl, param)


SHAPE = (200, 300)


def _draw(init, shape=SHAPE, dtype="float32"):
    return init(list(shape), dtype).float().numpy()


@pytest.mark.parametrize("name,make,mean,std", [
    ("Normal", lambda I: I.Normal(0.5, 2.0), 0.5, 2.0),
    ("XavierNormal", lambda I: I.XavierNormal(), 0.0,
     math.sqrt(2.0 / 500)),
    ("XavierNormal_gain", lambda I: I.XavierNormal(fan_in=10, fan_out=30,
                                                   gain=2.0), 0.0,
     2.0 * math.sqrt(2.0 / 40)),
    ("KaimingNormal", lambda I: I.KaimingNormal(), 0.0,
     math.sqrt(2.0) / math.sqrt(200)),
    ("KaimingNormal_leaky", lambda I: I.KaimingNormal(
        negative_slope=0.1, nonlinearity="leaky_relu"), 0.0,
     math.sqrt(2.0 / 1.01) / math.sqrt(200))])
def test_normal_initializers_by_moments(name, make, mean, std):
    tp.seed(1)
    jp.seed(1)
    a = _draw(make(TI))
    j = np.asarray(make(JI)(list(SHAPE), "float32"))
    for arr in (a, j):
        assert abs(arr.mean() - mean) < 4 * std / math.sqrt(arr.size)
        assert abs(arr.std() / std - 1) < 0.01
    tp.seed(1)
    np.testing.assert_array_equal(_draw(make(TI)), a)


@pytest.mark.parametrize("name,make,lo,hi", [
    ("Uniform", lambda I: I.Uniform(-0.3, 0.7), -0.3, 0.7),
    ("XavierUniform", lambda I: I.XavierUniform(),
     -math.sqrt(6 / 500), math.sqrt(6 / 500)),
    ("KaimingUniform", lambda I: I.KaimingUniform(),
     -math.sqrt(2) * math.sqrt(3 / 200), math.sqrt(2) * math.sqrt(3 / 200)),
    ("TruncatedNormal", lambda I: I.TruncatedNormal(1.0, 0.5, -1.0, 1.5),
     0.5, 1.75)])
def test_bounded_initializers_by_range_and_mean(name, make, lo, hi):
    tp.seed(2)
    jp.seed(2)
    a = _draw(make(TI))
    j = np.asarray(make(JI)(list(SHAPE), "float32"))
    for arr in (a, j):
        assert arr.min() >= lo - 1e-6 and arr.max() <= hi + 1e-6
        assert abs(arr.mean() - j.mean()) < 0.01 * (hi - lo)
        assert abs(arr.std() - j.std()) < 0.01 * (hi - lo)


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (2, 3, 5)])
def test_orthogonal_initializer(shape):
    a = _draw(TI.Orthogonal(gain=1.5), shape)
    m = a.reshape(-1, shape[-1]) / 1.5
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)
    assert a.shape == shape


@pytest.mark.parametrize("make", [
    lambda I, xp: I.Constant(0.25),
    lambda I, xp: I.Assign(np.arange(12, dtype=np.float32).reshape(3, 4)),
    lambda I, xp: I.Assign(xp.to_tensor(np.ones((12,), np.float32))),
    lambda I, xp: I.Dirac(),
    lambda I, xp: I.Dirac(groups=2)], ids=["constant", "assign",
                                           "assign_tensor", "dirac",
                                           "dirac_groups"])
def test_deterministic_initializers_are_exact(make):
    shape = [4, 2, 3, 3] if "Dirac" in type(make(TI, tp)).__name__ \
        else [3, 4]
    a = make(TI, tp)(shape, "float32")
    b = make(JI, jp)(shape, "float32")
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert a.dtype == torch.float32
    assert make(TI, tp)(shape, "bfloat16").dtype == torch.bfloat16


def test_bilinear_initializer_is_exact():
    t = tp.create_parameter([2, 3, 4, 5], "float32")
    j = jp.create_parameter([2, 3, 4, 5], "float32")
    TI.Bilinear()(t)
    JI.Bilinear()(j)
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j.numpy()))


# names held by a test of their own rather than by a table entry
HELD_ELSEWHERE = {
    # test_torch_nn_activation.py (in place) and _functional.py (draws)
    "relu_", "softmax_", "dropout", "rrelu", "gumbel_softmax",
    "class_center_sample", "cross_entropy",
    # test_torch_nn_extra_losses.py (tails are pairs)
    "adaptive_log_softmax_with_loss",
    # test_torch_resnet.py (the batch norm's functional)
    "batch_norm",
    # this file and test_torch_nn_layers.py
    "Sequential", "LayerList", "LayerDict", "ParameterList",
    "ParameterDict", "RReLU",
    # test_torch_nn_transformer*.py
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer"}


def test_every_name_of_the_slice_is_held_by_a_parity_test():
    """Every name of this slice's JAX modules is a case of a table
    (functionals by dotted path, layers by name) or held by a test of
    its own (``HELD_ELSEWHERE``)."""
    import torch_nn_table_functional as tf
    import torch_nn_table_layers as tl
    cased = {c.op.rpartition(".")[2] for t in (
        tf.ACTIVATIONS, tf.COMMON, tf.SPATIAL, tf.NORM, tf.LOSSES,
        tf.EXTRA) for c in t}
    cased |= {e.name for t in (tl.ACTIVATION_LAYERS, tl.COMMON_LAYERS,
                               tl.NORM_LAYERS, tl.LOSS_LAYERS) for e in t}
    want = set()
    for mod in ("activation", "common", "norm", "loss", "extra_losses"):
        want |= set(importlib.import_module(
            f"paddle2_tpu.nn.functional.{mod}").__all__)
    for mod in LAYER_MODULES:
        want |= set(importlib.import_module(
            f"paddle2_tpu.nn.layer.{mod}").__all__)
    assert sorted(want - cased - HELD_ELSEWHERE) == []
