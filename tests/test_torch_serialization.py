"""The port's wire (``fedml_tpu_torch.utils.serialization``) against the
reference's (``fedml_tpu.utils.serialization``) on the CPU: for the same
content — nested trees of f32/bf16/int8/int64 arrays, tuples, bytes and
non-string keys, a converted model tree, and a ``CompressedTree`` of every
codec — the port's ``safe_dumps`` gives the reference's bytes exactly; each
package's ``safe_loads`` reads the other's bytes to equal values; and every
hostile payload the reference rejects, the port rejects the same way."""
import io
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import arguments as jarguments
from fedml_tpu.compression import derive_key as jderive_key
from fedml_tpu.compression import get_codec as jget_codec
from fedml_tpu.models import model_hub as jhub
from fedml_tpu.utils import serialization as J
from fedml_tpu_torch.compression import CompressedTree, derive_key, get_codec
from fedml_tpu_torch.models.convert import (
    from_flax_params,
    from_wire_params,
    to_reference_layout,
    to_wire_params,
)
from fedml_tpu_torch.utils import serialization as T


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "bf16": rng.normal(size=(7,)).astype(np.float32),
        "i8": rng.integers(-128, 127, size=(4, 2)).astype(np.int8),
        "i64": rng.integers(-10**12, 10**12, size=(6,)).astype(np.int64),
        "scalar": np.float32(2.5),
    }


def _nested_pair():
    a = _arrays()
    jt = {"layer": {"w": jnp.asarray(a["f32"]),
                    "h": jnp.asarray(a["bf16"]).astype(jnp.bfloat16)},
          "codes": jnp.asarray(a["i8"]), "ids": a["i64"], "zero_d": np.zeros(()),
          "scalar": a["scalar"], "meta": {"lr": 0.1, "steps": 5, "name": "m",
                                          "flags": [True, None, 2.5]}}
    tt = {"layer": {"w": torch.from_numpy(a["f32"]),
                    "h": torch.from_numpy(a["bf16"]).to(torch.bfloat16)},
          "codes": torch.from_numpy(a["i8"]), "ids": torch.from_numpy(a["i64"]),
          "zero_d": torch.zeros((), dtype=torch.float64),
          "scalar": a["scalar"], "meta": {"lr": 0.1, "steps": 5, "name": "m",
                                          "flags": [True, None, 2.5]}}
    return jt, tt


def _containers_pair():
    a = _arrays(1)
    jt = {"shapes": (1, 2, (3, "x")), "pk": b"\x00\x01\xffraw", 1: "a",
          (2, 3): a["i64"], "__ndarray__": 0, "inner": {"__tuple__": "tuple", "items": [1]},
          "__codec__": "not-a-payload", "t": (jnp.asarray(a["f32"]), [b"", None])}
    tt = {"shapes": (1, 2, (3, "x")), "pk": b"\x00\x01\xffraw", 1: "a",
          (2, 3): torch.from_numpy(a["i64"]), "__ndarray__": 0,
          "inner": {"__tuple__": "tuple", "items": [1]},
          "__codec__": "not-a-payload", "t": (torch.from_numpy(a["f32"]), [b"", None])}
    return jt, tt


def _model_pair(name):
    """A reference model's initial weights and the port's tree of them, in
    the message form (nested, the reference's layout)."""
    cfg = {"common_args": {"random_seed": 0},
           "data_args": {"dataset": "cifar10"},
           "model_args": {"model": name, "group_norm_channels": 2}}
    jargs = fedml_tpu.init(jarguments.load_arguments_from_dict(cfg))
    jm = jhub.create(jargs, 10)
    params = jhub.init_params(jm, jargs, np.zeros((2, 32, 32, 3), np.float32))
    params = jax.tree.map(np.asarray, params)
    return params, to_wire_params(from_flax_params(params))


def _leaf_trees(seed=3):
    """The same float tree twice: nested for JAX, flat by path for the port."""
    rng = np.random.default_rng(seed)
    kernel = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)  # HWIO
    dense = rng.normal(size=(20, 6)).astype(np.float32)         # [in, out]
    bias = rng.normal(size=(6,)).astype(np.float32) * 0.1
    steps = np.arange(3, dtype=np.int32)
    jt = {"params": {"Conv_0": {"kernel": jnp.asarray(kernel)},
                     "Dense_0": {"bias": jnp.asarray(bias), "kernel": jnp.asarray(dense)}},
          "steps": jnp.asarray(steps)}
    port = from_flax_params(jt)
    return jt, to_reference_layout(port)


CODECS = ["identity", "bf16", "int8", "topk", "int4", "nf4"]


def _content(kind):
    if kind == "nested":
        return _nested_pair()
    if kind == "containers":
        return _containers_pair()
    if kind.startswith("model:"):
        return _model_pair(kind.split(":")[1])
    codec = kind.split(":")[1]
    jt, tt = _leaf_trees()
    key_j, key_t = jderive_key(0, 2, 5), derive_key(0, 2, 5)
    return (jget_codec(codec).encode(jt, key=key_j, is_delta=True),
            get_codec(codec).encode(tt, key=key_t, is_delta=True))


KINDS = (["nested", "containers", "model:cnn", "model:resnet18"]
         + [f"codec:{c}" for c in CODECS])


def _host(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _assert_same(port, ref):
    """A port-decoded object equals a reference-decoded one: same
    containers and scalars, arrays equal bit for bit in dtype and shape."""
    from fedml_tpu.compression.codecs import CompressedTree as JCompressedTree

    if isinstance(ref, JCompressedTree):
        assert isinstance(port, CompressedTree)
        assert (port.codec, port.version, port.is_delta, port.raw_nbytes, port.meta) == (
            ref.codec, ref.version, ref.is_delta, ref.raw_nbytes, ref.meta)
        flat_ref, _ = jax.tree.flatten(ref.structure)
        paths = ["/".join(str(getattr(k, "key", k)) for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(ref.structure)[0]]
        assert list(port.structure) == [paths[flat_ref.index(i)] for i in range(len(paths))]
        _assert_same(port.arrays, ref.arrays)
        return
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref)
        for k in ref:
            _assert_same(port[k], ref[k])
        return
    if isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_same(p, r)
        return
    if isinstance(ref, (np.ndarray, np.generic, jax.Array)):
        assert isinstance(port, torch.Tensor)
        (pa, pdt), (ra, rdt) = _host(port), _host(ref)
        assert pdt == rdt and pa.shape == ra.shape and np.array_equal(pa, ra)
        return
    assert port == ref and type(port) is type(ref)


@pytest.mark.parametrize("kind", KINDS)
def test_port_dumps_the_reference_bytes(kind):
    ref_obj, port_obj = _content(kind)
    assert T.safe_dumps(port_obj) == J.safe_dumps(ref_obj)


@pytest.mark.parametrize("kind", KINDS)
def test_each_side_reads_the_other(kind):
    ref_obj, port_obj = _content(kind)
    ref_bytes, port_bytes = J.safe_dumps(ref_obj), T.safe_dumps(port_obj)
    _assert_same(T.safe_loads(ref_bytes), J.safe_loads(ref_bytes))
    _assert_same(T.safe_loads(port_bytes), J.safe_loads(port_bytes))


@pytest.mark.parametrize("codec", CODECS)
def test_wire_compressed_tree_decodes_to_the_reference_tree(codec):
    """A reference upload read by the port decodes to the reference's own
    decode, leaf for leaf (in the reference's layout)."""
    jt, _ = _leaf_trees()
    ct = jget_codec(codec).encode(jt, key=jderive_key(1, 0, 2), is_delta=True)
    want = jax.tree.map(np.asarray, jget_codec(codec).decode(ct))
    got = get_codec(codec).decode(T.safe_loads(J.safe_dumps(ct)))
    want_flat = {"/".join(str(k.key) for k in p): v
                 for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(want_flat)
    for k, v in want_flat.items():
        assert got[k].dtype == torch.from_numpy(np.array(v)).dtype
        assert np.array_equal(got[k].numpy(), v)


def test_wire_model_tree_comes_back_in_the_port_layout():
    params, wire = _model_pair("cnn")
    port = from_flax_params(params)
    back = from_wire_params(T.safe_loads(J.safe_dumps(params)), "cpu")
    assert list(back) == list(port)
    for k in port:
        assert torch.equal(back[k], port[k]) and back[k].is_contiguous()
    assert T.safe_dumps(wire) == J.safe_dumps(params)


def test_decoded_tensors_own_their_memory():
    """The port copies each array out of the message once: the tensors are
    writable and writing them leaves the payload bytes alone."""
    payload = J.safe_dumps({"w": np.arange(64, dtype=np.float32)})
    before = bytes(payload)
    out = T.safe_loads(payload)
    out["w"] += 1
    assert payload == before
    assert torch.equal(out["w"], torch.arange(64, dtype=torch.float32) + 1)
    f = np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4))
    got = T.safe_loads(J.safe_dumps({"f": f}))["f"]
    assert got.is_contiguous() and np.array_equal(got.numpy(), f)


@pytest.mark.parametrize("kind", ["nested", "model:cnn", "codec:int8", "codec:topk"])
def test_tree_nbytes_is_the_reference_count(kind):
    """The offload threshold reads this count: the port's equals the
    reference's on the same content (a compressed tree counts its encoded
    arrays)."""
    ref_obj, port_obj = _content(kind)
    assert T.tree_nbytes(port_obj) == J.tree_nbytes(ref_obj)


def _raw(skeleton, arrays, tail=b"\x00" * 64):
    header = json.dumps({"skeleton": skeleton, "arrays": arrays}).encode()
    return struct.pack("<I", len(header)) + header + tail


def _int8_payload():
    jt, _ = _leaf_trees()
    return jget_codec("int8").encode(jt, key=jderive_key(0, 0, 1))


def _object_npy():
    """An npy blob that declares an object (pickled) array."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": "|O", "fortran_order": False, "shape": (1,)})
    return buf.getvalue() + b"\x00" * 8


def _versioned(v):
    ct = _int8_payload()
    ct.version = v
    return J.safe_dumps(ct)


HOSTILE = {
    "bad blob index": lambda: _raw({"__ndarray__": 99}, []),
    "blob overruns payload": lambda: _raw({"__ndarray__": 0}, [10 ** 12]),
    "negative blob size": lambda: _raw({"__ndarray__": 0}, [-4]),
    "bytes tag on a dict": lambda: _raw({"__bytes__": {"x": 1}}, []),
    "array tag on a bytes blob": lambda: J.safe_dumps({"b": b"RAW0xx"}).replace(
        b'{"__bytes__": 0}', b'{"__ndarray__": 0}'),
    "tuple items not a list": lambda: _raw({"__tuple__": "tuple", "items": 7}, []),
    "dict_items pair of one": lambda: _raw({"__tuple__": "dict_items", "items": [[1]]}, []),
    "codec tag not a string": lambda: _raw({"__codec__": 3, "v": 1}, []),
    "unknown codec tag": lambda: _raw({"__codec__": "evil", "v": 1, "meta": [],
                                       "structure": [], "state": []}, []),
    "unknown wire version": lambda: _raw({"__codec__": "int8", "v": 99}, []),
    "version 3": lambda: _versioned(3),
    "masked wire on a plain codec": lambda: _versioned(2),
    "meta not a list": lambda: _raw({"__codec__": "int8", "v": 1, "meta": "x",
                                     "structure": [], "state": []}, []),
    "unknown extension dtype": lambda: _raw({"__ndarray__": 0, "dt": "evil"}, [4]),
    "malformed header": lambda: _raw(None, "nope"),
    "short payload": lambda: b"\x01\x00",
    "header overruns payload": lambda: struct.pack("<I", 999) + b"{}",
    "truncated array blob": lambda: J.safe_dumps(
        {"w": np.arange(64, dtype=np.float64)})[:-8],
    "not npy": lambda: _raw({"__ndarray__": 0}, [8], b"notnpy!!"),
    "object dtype": lambda: _raw({"__ndarray__": 0}, [len(_object_npy())],
                                 _object_npy()),
}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_hostile_payloads_rejected_like_the_reference(case):
    payload = HOSTILE[case]()
    with pytest.raises(ValueError) as ref:
        J.safe_loads(payload)
    with pytest.raises(ValueError) as port:
        T.safe_loads(payload)
    if "version" in case or "maskable" in str(ref.value) or "codec" in case:
        assert str(port.value).split()[:2] == str(ref.value).split()[:2], (
            port.value, ref.value)


def test_truncation_fuzz_raises_value_error_only():
    """Every prefix of a real payload, and random corruption of its header,
    fails as ValueError on both sides (or decodes on both)."""
    rng = np.random.default_rng(5)
    jt, tt = _leaf_trees()
    wire = T.safe_dumps({"m": get_codec("int8").encode(tt, key=derive_key(0, 0, 1)),
                         "plain": torch.arange(64, dtype=torch.float64), "b": b"\x00raw"})
    cuts = list(range(0, 12)) + list(range(12, len(wire) - 1, 97))
    corrupted = []
    for _ in range(20):
        c = bytearray(wire)
        for _ in range(8):
            c[int(rng.integers(0, min(len(wire), 400)))] = int(rng.integers(0, 256))
        corrupted.append(bytes(c))
    for payload in [wire[:cut] for cut in cuts] + corrupted:
        outcomes = []
        for loads in (J.safe_loads, T.safe_loads):
            try:
                loads(payload)
                outcomes.append("ok")
            except ValueError:
                outcomes.append("ValueError")
        assert outcomes[0] == outcomes[1], outcomes


def test_reserved_keys_and_unsupported_types_like_the_reference():
    obj = {"__ndarray__": 0, "inner": {"__tuple__": "tuple", "items": [1, 2]},
           "b": {"__bytes__": 7}, "__codec__": "x"}
    assert T.safe_loads(T.safe_dumps(obj)) == J.safe_loads(J.safe_dumps(obj)) == obj
    for bad in ({"f": object()}, {"s": {1, 2}}):
        with pytest.raises(TypeError):
            J.safe_dumps(bad)
        with pytest.raises(TypeError):
            T.safe_dumps(bad)


def test_masked_wire_is_refused_naming_its_item():
    """A masked (v2) node of the secure-aggregation codec is a legal wire
    the port cannot open yet: it raises naming its ROADMAP part."""
    node = {"__codec__": "secagg_int8", "v": 2, "meta": [], "structure": [],
            "state": [], "sa": {}}
    with pytest.raises(NotImplementedError, match=r"A10\.2"):
        T.safe_loads(_raw(node, []))
