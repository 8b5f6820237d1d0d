"""Weight conversion from external formats: the port of
``ocrs_tpu.models.convert``.

The upstream project executes ``.rten`` model binaries converted from ONNX
exports of the ocrs-models PyTorch training repo. The weight files here are
the flat ``.npz`` of the JAX parameter tree (:mod:`.weights`); this module
converts into that tree, in numpy, from:

  * **PyTorch state dicts** (``convert_torch_state_dict``): the upstream
    models are trained in PyTorch, so this is the route to their weights.
  * **ONNX** (``convert_onnx``): the format upstream distributes. A built-in
    protobuf wire-format reader extracts the graph (no ``onnx`` package
    needed), GRU initializers are split per direction and gate-reordered
    from ONNX (z,r,h) to torch (r,z,n) layout, then the same strict
    shape+name mapping applies.

Both converters are deliberately strict: they verify every target leaf is
covered exactly once and report what didn't match, because a silently
mismapped weight is worse than an error. Torch's OIHW / ``[3H, C]`` layouts
become the tree's HWIO / ``[C, 3H]`` ones in ``_adapt``. Given the same
source and the same target tree, the result is the JAX package's, leaf for
leaf. :func:`target_params` makes a target tree from the port's own models
and :func:`load_converted_model` builds a port model from the result
(through ``weights.params_from_jax``).
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np


def _flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, np.ndarray]]:
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_flatten_with_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(_flatten_with_paths(v, f"{prefix}{i}/"))
    else:
        out.append((prefix[:-1], np.asarray(tree)))
    return out


def _set_by_path(tree: Any, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    last = parts[-1]
    if isinstance(node, (list, tuple)):
        node[int(last)] = value
    else:
        node[last] = value


def _adapt(source: np.ndarray, target_shape: tuple[int, ...]) -> np.ndarray | None:
    """Try to view `source` as `target_shape`, applying the standard
    torch->JAX layout changes: OIHW->HWIO for conv kernels and [out,in] ->
    [in,out] transposes for dense/GRU matrices."""
    src = np.asarray(source)
    if src.shape == tuple(target_shape):
        return src
    if src.ndim == 4 and tuple(np.transpose(src, (2, 3, 1, 0)).shape) == tuple(target_shape):
        return np.transpose(src, (2, 3, 1, 0))  # OIHW -> HWIO
    if src.ndim == 2 and src.T.shape == tuple(target_shape):
        return src.T
    return None


def _name_hint_score(source_name: str, target_path: str) -> int:
    """Affinity between a torch parameter name and a target leaf path.

    Disambiguates same-shaped tensors: GRU direction (``_reverse`` <-> bwd)
    and role (``weight_ih``/``weight_hh``/``bias_ih``/``bias_hh`` <->
    wx/wh/bx/bh). Shape-adaptable candidates with the highest score win;
    ties fall back to source declaration order."""
    score = 0
    is_reverse = "reverse" in source_name
    if "/bwd/" in target_path or target_path.endswith("bwd"):
        score += 4 if is_reverse else -4
    elif "/fwd/" in target_path:
        score += 4 if not is_reverse else -4
    leaf = target_path.rsplit("/", 1)[-1]
    for token, tgt in (
        ("weight_ih", "wx"),
        ("weight_hh", "wh"),
        ("bias_ih", "bx"),
        ("bias_hh", "bh"),
    ):
        if token in source_name:
            score += 4 if leaf == tgt else -4
    return score


def convert_torch_state_dict(state_dict: dict, target_params: Any) -> Any:
    """Map a PyTorch ``state_dict`` onto `target_params` by shape signature
    plus name hints.

    Target leaves are traversed in sorted-path order (a JAX pytree's
    canonical dict ordering — NOT python declaration order, which jax tree
    ops do not preserve); each takes the unconsumed source tensor that
    adapts to its shape with the highest name-hint affinity
    (:func:`_name_hint_score`), ties resolved by source declaration order.
    Raises with a detailed report when coverage is not exact.
    """
    import copy

    result = copy.deepcopy(
        {"__root__": target_params}
    )["__root__"]  # deep copy of nested dict/list structure
    targets = sorted(_flatten_with_paths(result), key=lambda kv: kv[0])
    sources = [(k, np.asarray(v)) for k, v in state_dict.items()]
    used = [False] * len(sources)
    unmatched = []
    for path, leaf in targets:
        best = None  # (neg_score, order, index, adapted)
        for i, (name, src) in enumerate(sources):
            if used[i]:
                continue
            adapted = _adapt(src, leaf.shape)
            if adapted is None:
                continue
            key = (-_name_hint_score(name, path), i)
            if best is None or key < best[0]:
                best = (key, i, adapted)
        if best is None:
            unmatched.append((path, leaf.shape))
            continue
        used[best[1]] = True
        _set_by_path(result, path, best[2].astype(np.float32))
    if unmatched:
        leftover = [sources[i][0] for i in range(len(sources)) if not used[i]]
        raise ValueError(
            "state dict does not cover the target parameters.\n"
            f"unmatched targets: {unmatched}\n"
            f"unused sources: {leftover}"
        )
    return result


# ---------------------------------------------------------------------------
# Minimal ONNX reading — protobuf wire-format parser, no `onnx` dependency.
#
# The upstream distributed models are ONNX exports of the ocrs-models
# PyTorch repo (downloaded then converted to .rten — ocrs-cli/src/models.rs:
# 44-64). ONNX files are protobuf; the handful of fields needed to recover
# the weights (graph -> initializer TensorProtos + node op/input lists) are
# parsed here directly so conversion works in environments without the
# `onnx` package installed.
# ---------------------------------------------------------------------------

# TensorProto.DataType -> numpy dtype (only types that can carry weights).
_ONNX_DTYPES = {
    1: np.float32,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
}


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _pb_fields(buf: bytes) -> Iterable[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) records from a message body."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            val, i = buf[i : i + 8], i + 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wt == 5:  # 32-bit
            val, i = buf[i : i + 4], i + 4
        else:  # groups (3/4) do not occur in ONNX
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def _parse_tensor(buf: bytes) -> tuple[str, "np.ndarray | None"]:
    """Parse a TensorProto: (name, array) — array None for non-weight types."""
    name, dims, dtype = "", [], 0
    raw = b""
    typed: list[Any] = []
    for field, wt, val in _pb_fields(buf):
        if field == 1:  # dims (varint, possibly packed)
            if wt == 0:
                dims.append(val)
            else:
                j = 0
                while j < len(val):
                    d, j = _read_varint(val, j)
                    dims.append(d)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
        elif field == 4 and wt == 2:  # packed float_data
            typed.append(np.frombuffer(val, np.float32))
        elif field == 10 and wt == 2:  # packed double_data
            typed.append(np.frombuffer(val, np.float64))
        elif field == 7:  # int64_data (packed varints)
            if wt == 2:
                j, out = 0, []
                while j < len(val):
                    d, j = _read_varint(val, j)
                    out.append(np.int64(d) if d < 1 << 63 else np.int64(d - (1 << 64)))
                typed.append(np.asarray(out, np.int64))
            else:
                typed.append(np.asarray([val], np.int64))
    np_dtype = _ONNX_DTYPES.get(dtype)
    if np_dtype is None:
        return name, None
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif typed:
        arr = np.concatenate(typed).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims)


def _parse_node(buf: bytes) -> dict:
    """Parse a NodeProto into {op_type, inputs, attrs:{name: int|str}}."""
    node: dict[str, Any] = {"op_type": "", "inputs": [], "attrs": {}}
    for field, _wt, val in _pb_fields(buf):
        if field == 1:
            node["inputs"].append(val.decode())
        elif field == 4:
            node["op_type"] = val.decode()
        elif field == 5:  # AttributeProto
            aname, aval = "", None
            for af, _awt, av in _pb_fields(val):
                if af == 1:
                    aname = av.decode()
                elif af == 3:  # i
                    aval = av
                elif af == 4:  # s
                    aval = av.decode()
            if aname:
                node["attrs"][aname] = aval
    return node


def parse_onnx(path_or_bytes: "str | bytes") -> tuple[dict, list[dict]]:
    """Read an ONNX file: (initializers {name: array}, nodes in graph order)."""
    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = path_or_bytes
    graph = None
    for field, _wt, val in _pb_fields(data):
        if field == 7:  # ModelProto.graph
            graph = val
    if graph is None:
        raise ValueError("not an ONNX ModelProto: no graph field")
    inits: dict[str, np.ndarray] = {}
    nodes: list[dict] = []
    for field, _wt, val in _pb_fields(graph):
        if field == 5:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            if arr is not None:
                inits[name] = arr
        elif field == 1:  # GraphProto.node
            nodes.append(_parse_node(val))
    return inits, nodes


def _gru_state_entries(
    layer: int, w: np.ndarray, r: np.ndarray, b: "np.ndarray | None"
) -> dict:
    """Convert one ONNX GRU node's W/R/B initializers to torch-layout entries.

    ONNX GRU (torch export, ``linear_before_reset=1``) stacks directions and
    orders gates (z, r, h); torch state dicts keep per-direction
    ``weight_ih_l0`` [3H, I] with gates (r, z, n) — the layout
    :func:`convert_torch_state_dict` expects (models/nn.py gru_apply).
    """
    d, three_h, _ = w.shape
    h = three_h // 3
    perm = np.concatenate([np.arange(h, 2 * h), np.arange(0, h), np.arange(2 * h, 3 * h)])
    out = {}
    for di in range(d):
        sfx = "_reverse" if di == 1 else ""
        out[f"gru{layer}.weight_ih_l0{sfx}"] = w[di][perm]
        out[f"gru{layer}.weight_hh_l0{sfx}"] = r[di][perm]
        if b is not None:
            out[f"gru{layer}.bias_ih_l0{sfx}"] = b[di][:three_h][perm]
            out[f"gru{layer}.bias_hh_l0{sfx}"] = b[di][three_h:][perm]
    return out


def onnx_to_state_dict(path_or_bytes: "str | bytes") -> dict:
    """Extract a torch-style weight state dict from an ONNX export.

    Float initializers pass through under their graph names (torch exports
    keep original parameter names for conv/dense weights); each GRU node's
    stacked (z,r,h)-ordered W/R/B initializers are split per direction and
    re-ordered to torch's (r,z,n) ``weight_ih``/``weight_hh``/``bias_*``
    layout. Integer initializers (shape/pad constants) are dropped — they
    are graph plumbing, not weights.
    """
    inits, nodes = parse_onnx(path_or_bytes)
    state: dict[str, np.ndarray] = {}
    consumed: set[str] = set()
    gru_idx = 0
    for node in nodes:
        if node["op_type"] != "GRU":
            continue
        if node["attrs"].get("linear_before_reset", 0) != 1:
            raise ValueError(
                "ONNX GRU without linear_before_reset=1: not a torch export; "
                "this converter implements torch GRU semantics only"
            )
        ins = node["inputs"]
        w, r = inits[ins[1]], inits[ins[2]]
        b = inits.get(ins[3]) if len(ins) > 3 and ins[3] else None
        state.update(_gru_state_entries(gru_idx, w, r, b))
        consumed.update(n for n in ins[1:4] if n)
        gru_idx += 1
    for name, arr in inits.items():
        if name in consumed or not np.issubdtype(arr.dtype, np.floating):
            continue
        state[name] = arr
    return state


def convert_onnx(onnx_path: "str | bytes", target_params: Any) -> Any:
    """Convert an ONNX model's weights onto `target_params`.

    Self-contained (built-in protobuf parsing — no ``onnx`` package needed):
    reads the graph with :func:`parse_onnx`, normalizes it to a torch-style
    state dict with :func:`onnx_to_state_dict` (GRU splitting/gate
    reordering included), then maps by shape + name hints via
    :func:`convert_torch_state_dict`.
    """
    return convert_torch_state_dict(onnx_to_state_dict(onnx_path), target_params)


def target_params(kind: str, arch: str = "crnn", n_classes: int = 97, hidden: int | None = None) -> Any:
    """A conversion target: the JAX-layout tree (numpy leaves) of a freshly
    made port model of `kind` ("recognition" of `arch` at GRU size or
    ConvCTC dim `hidden`, or "detection"). Only its structure and shapes
    matter to the converters."""
    from .detection_net import DetectionModel
    from .recognition_net import RecognitionModel
    from .weights import params_to_jax

    if kind == "recognition":
        model = RecognitionModel(None, arch, n_classes=n_classes, hidden=hidden)
    elif kind == "detection":
        model = DetectionModel.create()
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    return params_to_jax(model.net.state_dict())


def load_converted_model(params: Any, kind: str, arch: str = "crnn"):
    """The port's ``RecognitionModel`` (of `arch`) or ``DetectionModel`` with
    a converted JAX-layout tree, carried across by ``params_from_jax``; on
    the CPU (``.to(device)`` moves it)."""
    from .detection_net import DetectionModel
    from .recognition_net import RecognitionModel

    if kind == "recognition":
        return RecognitionModel(params, arch=arch)
    if kind == "detection":
        return DetectionModel(params)
    raise ValueError(f"unknown model kind {kind!r}")
