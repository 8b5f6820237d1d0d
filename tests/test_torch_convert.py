"""The port's weight conversion (ocrs_tpu_torch.models.convert) against the
JAX package's (ocrs_tpu.models.convert).

The source is the port's PyTorch twin of the CRNN (ocrs_tpu_torch.testing,
the twin of tests/test_convert.py): its state dict, and its ONNX export made
as tests/test_convert.py makes it (the TorchScript exporter, with the one
step that needs the ``onnx`` package bypassed). Both converters give the
same tree, leaf for leaf and exactly, on the port's target tree and on the
JAX package's; the converted model run by the port in float64 on the CPU
gives the twin's log-probs within 1e-8 and its greedy text.
"""

import jax
import numpy as np
import pytest
import torch

from ocrs_tpu.models import convert as J
from ocrs_tpu.models import recognition_net as jrec
from ocrs_tpu_torch.models import convert as T
from ocrs_tpu_torch.testing import torch_crnn_twin

HIDDEN, N_CLASSES = 16, 9


def _jax_target(hidden=HIDDEN, n_classes=N_CLASSES):
    """The JAX package's CRNN tree in zeros (its shapes are all a target
    needs; eval_shape draws nothing)."""
    shapes = jax.eval_shape(lambda: jrec.init_params(jax.random.key(0), n_classes, hidden))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _by_path(tree):
    return dict(J._flatten_with_paths(tree))


def _assert_same_tree(a, b):
    a, b = _by_path(a), _by_path(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_target_tree_is_the_jax_packages():
    port = {k: v.shape for k, v in _by_path(T.target_params("recognition", "crnn", N_CLASSES, HIDDEN)).items()}
    assert port == {k: v.shape for k, v in _by_path(_jax_target()).items()}


@pytest.mark.parametrize("seed", [1, 2])
def test_state_dict_conversion_equals_jax(seed):
    state = {k: v.numpy() for k, v in torch_crnn_twin(HIDDEN, N_CLASSES, seed).state_dict().items()}
    port = T.convert_torch_state_dict(state, T.target_params("recognition", "crnn", N_CLASSES, HIDDEN))
    _assert_same_tree(port, J.convert_torch_state_dict(state, _jax_target()))
    _assert_same_tree(port, T.convert_torch_state_dict(state, _jax_target()))


def test_shuffled_names_convert_by_shape_as_jax_does():
    # Arbitrary names in declaration order, torch layouts: the mapping goes
    # by shape and order alone (tests/test_convert.py's round trip).
    target = T.target_params("recognition", "crnn", N_CLASSES, HIDDEN)
    state = {}
    for i, (_, leaf) in enumerate(T._flatten_with_paths(target)):
        arr = np.random.default_rng(i).normal(size=leaf.shape).astype(np.float32)
        arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else (arr.T if arr.ndim == 2 else arr)
        state[f"module.layer{i}.weight"] = arr
    _assert_same_tree(T.convert_torch_state_dict(state, target), J.convert_torch_state_dict(state, target))


def test_mismatch_is_reported_as_jax_reports_it():
    params = {"a": {"w": np.zeros((4, 6))}}
    source = {"x": np.zeros((3, 3)), "y": np.zeros(5)}
    with pytest.raises(ValueError) as port:
        T.convert_torch_state_dict(source, params)
    with pytest.raises(ValueError) as jax_:
        J.convert_torch_state_dict(source, params)
    assert str(port.value) == str(jax_.value)
    assert "unmatched targets: [('a/w', (4, 6))]" in str(port.value) and "unused sources: ['x', 'y']" in str(port.value)


@pytest.fixture(scope="module")
def onnx_export(tmp_path_factory):
    """(twin in float64, ONNX bytes of it)."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    src = torch_crnn_twin(HIDDEN, N_CLASSES, 1).double()
    path = tmp_path_factory.mktemp("onnx") / "crnn.onnx"
    saved = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        torch.onnx.export(src, (torch.zeros(2, 1, 64, 96, dtype=torch.float64),), str(path), dynamo=False,
                          do_constant_folding=True)
    finally:
        onnx_proto_utils._add_onnxscript_fn = saved
    return src, path.read_bytes()


def test_onnx_conversion_equals_jax(onnx_export):
    _, data = onnx_export
    inits_t, nodes_t = T.parse_onnx(data)
    inits_j, nodes_j = J.parse_onnx(data)
    assert nodes_t == nodes_j and inits_t.keys() == inits_j.keys()
    for k in inits_t:
        np.testing.assert_array_equal(inits_t[k], inits_j[k])
    state_t, state_j = T.onnx_to_state_dict(data), J.onnx_to_state_dict(data)
    assert list(state_t) == list(state_j) and sum("weight_ih" in k for k in state_t) == 4
    for k in state_t:
        assert state_t[k].dtype == state_j[k].dtype
        np.testing.assert_array_equal(state_t[k], state_j[k])
    _assert_same_tree(T.convert_onnx(data, _jax_target()), J.convert_onnx(data, _jax_target()))


def test_onnx_gru_of_another_kind_is_refused():
    # A GRU node without linear_before_reset=1 (built by hand as protobuf).
    def field(num, wt, payload):
        key = bytes([num << 3 | wt])
        return key + (bytes([len(payload)]) + payload if wt == 2 else payload)

    node = field(1, 2, b"x") + field(1, 2, b"W") + field(1, 2, b"R") + field(4, 2, b"GRU")
    graph = field(1, 2, node)
    with pytest.raises(ValueError, match="linear_before_reset"):
        T.onnx_to_state_dict(field(7, 2, graph))
    with pytest.raises(ValueError, match="no graph"):
        T.parse_onnx(b"")


def _greedy(lp):
    from ocrs_tpu_torch.ops.ctc import collapse_greedy_batch

    return [[s.label for s in steps] for steps in collapse_greedy_batch(np.argmax(lp, axis=-1).T)]


@pytest.mark.parametrize("route", ["state_dict", "onnx"])
def test_converted_crnn_in_float64_matches_the_twin(onnx_export, route):
    src, data = onnx_export
    target = T.target_params("recognition", "crnn", N_CLASSES, HIDDEN)
    if route == "onnx":
        params = T.convert_onnx(data, target)
    else:
        params = T.convert_torch_state_dict({k: v.numpy() for k, v in src.state_dict().items()}, target)
    model = T.load_converted_model(params, "recognition", arch="crnn").to(torch.float64)
    x = np.random.default_rng(1).normal(size=(3, 1, 64, 96)) * 0.3
    with torch.no_grad():
        want = src(torch.from_numpy(x)).numpy()
        got = model.net(torch.from_numpy(x), torch.float64).numpy()
    assert got.shape == want.shape == (24, 3, N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)
    assert _greedy(got) == _greedy(want)


def test_load_converted_detection_model_takes_a_converted_tree():
    from ocrs_tpu_torch.models.detection_net import DetectionModel
    from ocrs_tpu_torch.models.weights import params_to_jax

    tree = T.target_params("detection")
    model = T.load_converted_model(tree, "detection")
    assert isinstance(model, DetectionModel)
    want = DetectionModel.create().net.state_dict()
    got = model.net.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert _by_path(params_to_jax(got)).keys() == _by_path(tree).keys()
    with pytest.raises(ValueError, match="kind"):
        T.load_converted_model(tree, "classifier")
