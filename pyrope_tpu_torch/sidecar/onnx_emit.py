"""Hand-rolled ONNX serialization of the policy GBDT.

The reference exports its GradientBoostingClassifier to ONNX via skl2onnx
and ships the artifact (ref: src/Pyrope.AISidecar/train_model.py:96-130,
policy_model.onnx). This image has no onnx/skl2onnx — but an .onnx file is
just a protobuf, and the sidecar already hand-rolls protobuf for its gRPC
contract (policy_service_pb2.py). This module emits a real, structurally
valid ONNX ModelProto containing one ai.onnx.ml TreeEnsembleClassifier
node, straight from the fitted sklearn ensemble:

- wire format: minimal protobuf encoder (varints + length-delimited
  fields), field numbers per the public onnx.proto3 schema
- tree extraction: each boosting stage's regression tree becomes
  (nodes_*, class_*) attribute rows; sklearn's ``X[f] <= threshold → left``
  split maps to BRANCH_LEQ with truenodeids = left child
- binary-classifier convention: leaf weights are ``learning_rate * value``
  votes for class 1, ``base_values`` carries the init estimator's log-odds
  prior, ``post_transform = LOGISTIC`` — score(x) = prior + Σ leaf weights,
  p₁ = σ(score), label = argmax([1−p₁, p₁]) (matches
  GradientBoostingClassifier.decision_function/predict)

``decode_model``/``evaluate`` parse the emitted bytes back and run the
ensemble, so tests verify the artifact semantically (predictions equal to
sklearn's on real inputs) — stronger than the reference's structural
checker — without fake modules. When skl2onnx IS present,
train_model.maybe_export_onnx still prefers it.
"""

from __future__ import annotations

import math
import struct
from typing import Sequence

# ---- protobuf wire-format primitives ---------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_int(field: int, v: int) -> bytes:
    return _tag(field, _VARINT) + _varint(int(v))


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


def _f_msg(field: int, v: bytes) -> bytes:
    return _f_bytes(field, v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, _I32) + struct.pack("<f", float(v))


def _packed_floats(field: int, vs: Sequence[float]) -> bytes:
    return _f_bytes(field, b"".join(struct.pack("<f", float(v)) for v in vs))


def _packed_ints(field: int, vs: Sequence[int]) -> bytes:
    return _f_bytes(field, b"".join(_varint(int(v)) for v in vs))


# ---- AttributeProto --------------------------------------------------------
# field numbers: name=1 f=2 i=3 s=4 floats=7 ints=8 strings=9 type=20
# AttributeType enum: FLOAT=1 INT=2 STRING=3 FLOATS=6 INTS=7 STRINGS=8

def attr_floats(name: str, vs: Sequence[float]) -> bytes:
    return _f_str(1, name) + _packed_floats(7, vs) + _f_int(20, 6)


def attr_ints(name: str, vs: Sequence[int]) -> bytes:
    return _f_str(1, name) + _packed_ints(8, vs) + _f_int(20, 7)


def attr_strings(name: str, vs: Sequence[str]) -> bytes:
    body = _f_str(1, name)
    for v in vs:
        body += _f_bytes(9, v.encode("utf-8"))
    return body + _f_int(20, 8)


def attr_string(name: str, v: str) -> bytes:
    return _f_str(1, name) + _f_bytes(4, v.encode("utf-8")) + _f_int(20, 3)


# ---- Type / ValueInfo ------------------------------------------------------
# TensorProto.DataType: FLOAT=1, INT64=7

def _tensor_type(elem: int, dims: Sequence[int | None]) -> bytes:
    shape = b""
    for d in dims:
        shape += _f_msg(1, _f_int(1, d) if d is not None else _f_str(2, "N"))
    tt = _f_int(1, elem) + _f_msg(2, shape)
    return _f_msg(1, tt)  # TypeProto.tensor_type = 1


def value_info(name: str, elem: int, dims: Sequence[int | None]) -> bytes:
    return _f_str(1, name) + _f_msg(2, _tensor_type(elem, dims))


# ---- model assembly --------------------------------------------------------

def gbdt_to_onnx(model, n_features: int, doc: str = "") -> bytes:
    """Serialize a fitted binary GradientBoostingClassifier to ONNX bytes.

    One TreeEnsembleClassifier node (domain ai.onnx.ml, opset 1); inputs
    'input' [N, n_features] float32, outputs 'label' [N] int64 and
    'probabilities' [N, 2] float32 (tensor output; the reference's skl2onnx
    flow appends a ZipMap which this emitter intentionally skips).
    """
    import numpy as np

    if getattr(model, "n_classes_", 2) != 2:
        raise ValueError("only the binary policy classifier is supported")
    lr = float(model.learning_rate)

    nodes_treeids: list[int] = []
    nodes_nodeids: list[int] = []
    nodes_featureids: list[int] = []
    nodes_values: list[float] = []
    nodes_modes: list[str] = []
    nodes_true: list[int] = []
    nodes_false: list[int] = []
    class_treeids: list[int] = []
    class_nodeids: list[int] = []
    class_ids: list[int] = []
    class_weights: list[float] = []

    for tid, est in enumerate(model.estimators_[:, 0]):
        t = est.tree_
        for nid in range(t.node_count):
            nodes_treeids.append(tid)
            nodes_nodeids.append(nid)
            left, right = int(t.children_left[nid]), int(t.children_right[nid])
            if left == -1:  # leaf
                nodes_featureids.append(0)
                nodes_values.append(0.0)
                nodes_modes.append("LEAF")
                nodes_true.append(0)
                nodes_false.append(0)
                class_treeids.append(tid)
                class_nodeids.append(nid)
                class_ids.append(1)
                class_weights.append(lr * float(t.value[nid][0][0]))
            else:
                nodes_featureids.append(int(t.feature[nid]))
                nodes_values.append(float(t.threshold[nid]))
                nodes_modes.append("BRANCH_LEQ")  # sklearn: x <= thr -> left
                nodes_true.append(left)
                nodes_false.append(right)

    # init estimator's log-odds prior (GradientBoostingClassifier default
    # init: DummyEstimator over class priors)
    probe = np.zeros((1, n_features), np.float64)
    prior = float(
        model._raw_predict_init(probe).ravel()[0]  # noqa: SLF001 — the
        # documented raw-score init; equals log(p1/(1-p1)) for default init
    )

    node = b"".join([
        _f_str(1, "input"),
        _f_str(2, "label"),
        _f_str(2, "probabilities"),
        _f_str(3, "policy_tree_ensemble"),
        _f_str(4, "TreeEnsembleClassifier"),
        _f_msg(5, attr_floats("base_values", [prior])),
        _f_msg(5, attr_ints("class_ids", class_ids)),
        _f_msg(5, attr_ints("class_nodeids", class_nodeids)),
        _f_msg(5, attr_ints("class_treeids", class_treeids)),
        _f_msg(5, attr_floats("class_weights", class_weights)),
        _f_msg(5, attr_ints("classlabels_int64s", [0, 1])),
        _f_msg(5, attr_ints("nodes_falsenodeids", nodes_false)),
        _f_msg(5, attr_ints("nodes_featureids", nodes_featureids)),
        _f_msg(5, attr_strings("nodes_modes", nodes_modes)),
        _f_msg(5, attr_ints("nodes_nodeids", nodes_nodeids)),
        _f_msg(5, attr_ints("nodes_treeids", nodes_treeids)),
        _f_msg(5, attr_ints("nodes_truenodeids", nodes_true)),
        _f_msg(5, attr_floats("nodes_values", nodes_values)),
        _f_msg(5, attr_string("post_transform", "LOGISTIC")),
        _f_str(7, "ai.onnx.ml"),
    ])

    graph = b"".join([
        _f_msg(1, node),
        _f_str(2, "pyrope_policy"),
        _f_msg(11, value_info("input", 1, [None, n_features])),
        _f_msg(12, value_info("label", 7, [None])),
        _f_msg(12, value_info("probabilities", 1, [None, 2])),
    ])
    if doc:
        graph += _f_str(10, doc)

    return b"".join([
        _f_int(1, 7),  # ir_version 7
        _f_msg(8, _f_str(1, "ai.onnx.ml") + _f_int(2, 1)),   # opset imports
        _f_msg(8, _f_str(1, "") + _f_int(2, 13)),
        _f_str(2, "pyrope_tpu"),
        _f_str(3, "1.0"),
        _f_msg(7, graph),
    ])


# ---- decoder + evaluator (self-verification without onnx/ort) --------------

def _iter_fields(buf: bytes):
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, v
        elif wire == _LEN:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, buf[i : i + ln]
            i += ln
        elif wire == _I32:
            yield field, wire, buf[i : i + 4]
            i += 4
        elif wire == _I64:
            yield field, wire, buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def decode_model(blob: bytes) -> dict:
    """Parse emitted bytes back into {opsets, graph_name, inputs, outputs,
    attrs} — the structural checker AND the evaluator's source of truth."""
    out = {"opsets": [], "inputs": [], "outputs": [], "attrs": {},
           "op_type": None, "domain": None, "ir_version": None}
    graph = None
    for f, w, v in _iter_fields(blob):
        if f == 1 and w == _VARINT:
            out["ir_version"] = v
        elif f == 8:
            dom, ver = "", 0
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1:
                    dom = v2.decode()
                elif f2 == 2:
                    ver = v2
            out["opsets"].append((dom, ver))
        elif f == 7:
            graph = v
    if graph is None:
        raise ValueError("no GraphProto in model")
    node = None
    for f, w, v in _iter_fields(graph):
        if f == 1:
            node = v
        elif f == 2:
            out["graph_name"] = v.decode()
        elif f == 11:
            out["inputs"].append(_decode_value_info(v))
        elif f == 12:
            out["outputs"].append(_decode_value_info(v))
    if node is None:
        raise ValueError("no NodeProto in graph")
    for f, w, v in _iter_fields(node):
        if f == 4:
            out["op_type"] = v.decode()
        elif f == 7:
            out["domain"] = v.decode()
        elif f == 5:
            name, val = _decode_attr(v)
            out["attrs"][name] = val
    return out


def _decode_value_info(buf: bytes) -> dict:
    name, elem, dims = None, None, []
    for f, w, v in _iter_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:
                                    dd = None
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dd = v5
                                    dims.append(dd)
    return {"name": name, "elem_type": elem, "dims": dims}


def _decode_attr(buf: bytes):
    name, atype = None, None
    raw = {}
    for f, w, v in _iter_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 20:
            atype = v
        else:
            raw.setdefault(f, []).append(v)
    if atype == 6:  # FLOATS (packed)
        b = raw[7][0]
        val = [struct.unpack("<f", b[i : i + 4])[0] for i in range(0, len(b), 4)]
    elif atype == 7:  # INTS (packed varints)
        b = raw[8][0]
        val = []
        v_, shift = 0, 0
        for byte in b:
            v_ |= (byte & 0x7F) << shift
            if byte & 0x80:
                shift += 7
            else:
                if v_ >= 1 << 63:
                    v_ -= 1 << 64
                val.append(v_)
                v_, shift = 0, 0
    elif atype == 8:  # STRINGS
        val = [b.decode() for b in raw[9]]
    elif atype == 3:  # STRING
        val = raw[4][0].decode()
    else:
        raise ValueError(f"unsupported attribute type {atype} for {name}")
    return name, val


def check_model(blob: bytes) -> dict:
    """Structural validation (the reference flow's onnx.checker analog):
    raises on malformed bytes / missing required pieces."""
    m = decode_model(blob)
    if m["op_type"] != "TreeEnsembleClassifier" or m["domain"] != "ai.onnx.ml":
        raise ValueError(f"unexpected node {m['domain']}.{m['op_type']}")
    if ("ai.onnx.ml", 1) not in m["opsets"]:
        raise ValueError("missing ai.onnx.ml opset import")
    a = m["attrs"]
    n = len(a["nodes_treeids"])
    for k in ("nodes_nodeids", "nodes_featureids", "nodes_modes",
              "nodes_values", "nodes_truenodeids", "nodes_falsenodeids"):
        if len(a[k]) != n:
            raise ValueError(f"attribute length mismatch: {k}")
    nleaf = len(a["class_treeids"])
    for k in ("class_nodeids", "class_ids", "class_weights"):
        if len(a[k]) != nleaf:
            raise ValueError(f"attribute length mismatch: {k}")
    if not m["inputs"] or not m["outputs"]:
        raise ValueError("graph must declare inputs and outputs")
    return m


def evaluate(blob: bytes, x) -> tuple[list[int], list[list[float]]]:
    """Run the emitted ensemble on x [N, F]: (labels, probabilities) —
    the reference flow's ort-smoke-inference analog, interpreting the SAME
    bytes a conformant runtime would."""
    m = check_model(blob)
    a = m["attrs"]
    # index trees: tree id -> {node id -> row}
    trees: dict[int, dict[int, int]] = {}
    for row, (tid, nid) in enumerate(zip(a["nodes_treeids"], a["nodes_nodeids"])):
        trees.setdefault(tid, {})[nid] = row
    leaf_w = {
        (t, nd): w
        for t, nd, w in zip(a["class_treeids"], a["class_nodeids"],
                            a["class_weights"])
    }
    base = a["base_values"][0]
    labels, probs = [], []
    for xi in x:
        score = base
        for tid, nodemap in trees.items():
            nid = 0
            while True:
                row = nodemap[nid]
                if a["nodes_modes"][row] == "LEAF":
                    score += leaf_w.get((tid, nid), 0.0)
                    break
                f = a["nodes_featureids"][row]
                if float(xi[f]) <= a["nodes_values"][row]:
                    nid = a["nodes_truenodeids"][row]
                else:
                    nid = a["nodes_falsenodeids"][row]
        p1 = 1.0 / (1.0 + math.exp(-score))
        probs.append([1.0 - p1, p1])
        labels.append(1 if p1 > 0.5 else 0)
    return labels, probs
