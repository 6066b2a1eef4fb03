"""Pytree (de)serialization at the transport boundary — counterpart of
``fedml_tpu/utils/serialization.py``, pickle-free and byte-compatible.

The wire format is the reference's, so a port peer and a JAX peer read
each other's messages:

    [4-byte header length][header JSON][npy blob]*
    header = {"skeleton": ..., "arrays": [nbytes, ...]}

The skeleton is JSON (dicts, lists, tuples and scalars with array
placeholders); arrays are raw ``.npy`` blobs read back with
``allow_pickle=False``, so a hostile payload can at worst give wrong
numbers, never run code. Every hostile shape the reference rejects raises
``ValueError`` here too. Compressed payloads ride as the reference's
versioned ``{"__codec__": name, "v": 1, ...}`` node, with the tree's
structure nested by path as JAX's pytree is, so for the same content
:func:`safe_dumps` gives the reference's bytes.

:func:`safe_dumps` takes torch tensors on any device and numpy arrays.
The card's tensors come to the host in one pass: each is copied into a
slice of one pinned buffer and the device is synchronised once.
:func:`safe_loads` gives torch tensors on the device the caller names,
never numpy arrays and never views of the message buffer: every array is
copied once — on the card through one pinned buffer and one host-to-device
copy, after which the leaves are views of that one device buffer. bf16
rides as the reference ships it, a ``uint16`` view with a ``"dt":
"bfloat16"`` tag, reinterpreted bit for bit with ``Tensor.view``.
"""
from __future__ import annotations

import io
import json
import struct
from typing import Any, Dict, List, Union

import numpy as np
import torch

from fedml_tpu_torch.device import DeviceLike

_ARRAY = "__ndarray__"
_TUPLE = "__tuple__"
_BYTES = "__bytes__"
_CODEC = "__codec__"
_RESERVED = (_ARRAY, _TUPLE, _BYTES, _CODEC)

# extension dtypes with no npy descr ride the wire as a same-itemsize
# integer view plus a "dt" tag on the array node
_EXT_DTYPES = {"bfloat16": np.dtype(np.uint16)}

# staging slices start on 64-byte boundaries, so every dtype view of the
# one staging buffer is aligned
_ALIGN = 64


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


# -- torch <-> numpy ----------------------------------------------------------

def _np_view(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor as numpy, sharing its memory; bf16 as the
    wire's ``uint16``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    try:
        return torch.from_numpy(np.empty(0, dt)).dtype
    except TypeError:
        raise ValueError(f"array dtype {dt} has no torch counterpart") from None


def _collect_device_tensors(obj: Any, out: Dict[int, torch.Tensor]) -> None:
    from fedml_tpu_torch.compression.codecs import CompressedTree

    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            out[id(obj)] = obj
    elif isinstance(obj, CompressedTree):
        _collect_device_tensors(obj.arrays, out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _collect_device_tensors(k, out)
            _collect_device_tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_device_tensors(v, out)


def _stage_to_host(tensors: List[torch.Tensor]) -> Dict[int, np.ndarray]:
    """Device tensors → host numpy in one pass: each copied (non-blocking)
    into its slice of one pinned buffer, then one synchronise per device."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    buf = torch.empty(sum(_aligned(n) for n in sizes), dtype=torch.uint8,
                      pin_memory=True)
    out, off = {}, 0
    for t, n in zip(tensors, sizes):
        dst = buf[off:off + n].view(t.dtype).view(t.shape)
        dst.copy_(t.detach(), non_blocking=True)
        out[id(t)] = _np_view(dst)
        off += _aligned(n)
    for dev in {t.device for t in tensors}:
        torch.cuda.synchronize(dev)
    return out


# -- encode -------------------------------------------------------------------

def _npy_parts(arr: np.ndarray):
    """(header_bytes, data) for one array, the data aliased where it can be
    (the reference's encode, byte for byte; an empty array of two or more
    dimensions, which the reference cannot alias, encodes too)."""
    d = np.lib.format.header_data_from_array_1_0(arr)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, d)
    header = buf.getvalue()
    if arr.ndim == 0:
        return header, arr.tobytes()
    # flattened first: a memoryview cannot cast a shape with a zero in it
    if arr.flags.c_contiguous:
        return header, memoryview(arr.reshape(-1).view(np.uint8))
    if d["fortran_order"] and arr.T.flags.c_contiguous:
        return header, memoryview(arr.T.reshape(-1).view(np.uint8))
    return header, arr.tobytes()


def _nest(structure) -> Dict[str, Any]:
    """A compressed tree's flat keys → the reference's structure node: the
    nested dict of each leaf's index, keys in the reference's order."""
    nested: Dict[str, Any] = {}
    for i, path in enumerate(structure):
        node = nested
        parts = str(path).split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = i
    return nested


def _encode(obj: Any, blobs: List[Any], host: Dict[int, np.ndarray]) -> Any:
    from fedml_tpu_torch.compression.codecs import CompressedTree

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (bytes, bytearray)):
        blobs.append(b"RAW0" + bytes(obj))
        return {_BYTES: len(blobs) - 1}
    if isinstance(obj, CompressedTree):
        return {
            _CODEC: obj.codec,
            "v": obj.version,
            "delta": obj.is_delta,
            "raw_nbytes": obj.raw_nbytes,
            "meta": [[dt, list(sh)] for dt, sh in obj.meta],
            "structure": _encode(_nest(obj.structure), blobs, host),
            "state": _encode(obj.arrays, blobs, host),
        }
    if isinstance(obj, torch.Tensor):
        if id(obj) in host:
            arr = host[id(obj)]
        else:
            arr = _np_view(obj.detach().contiguous())
        blobs.append(_npy_parts(arr))
        if obj.dtype == torch.bfloat16:
            return {_ARRAY: len(blobs) - 1, "dt": "bfloat16"}
        return {_ARRAY: len(blobs) - 1}
    if isinstance(obj, (np.ndarray, np.generic)):
        blobs.append(_npy_parts(np.asarray(obj)))
        return {_ARRAY: len(blobs) - 1}
    if isinstance(obj, dict):
        if any(not isinstance(k, str) or k in _RESERVED for k in obj):
            # non-string keys and keys that collide with the decode tags go
            # through the lossless items encoding
            return {
                _TUPLE: "dict_items",
                "items": [[_encode(k, blobs, host), _encode(v, blobs, host)]
                          for k, v in obj.items()],
            }
        return {k: _encode(v, blobs, host) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE: "tuple", "items": [_encode(v, blobs, host) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v, blobs, host) for v in obj]
    raise TypeError(
        f"safe serialization does not support {type(obj).__name__}; "
        "transport payloads must be trees of tensors/arrays/scalars/str")


def safe_dumps(obj: Any) -> bytes:
    device_tensors: Dict[int, torch.Tensor] = {}
    _collect_device_tensors(obj, device_tensors)
    host = _stage_to_host(list(device_tensors.values())) if device_tensors else {}
    blobs: List[Any] = []
    skeleton = _encode(obj, blobs, host)
    sizes = [sum(len(p) for p in b) if isinstance(b, tuple) else len(b)
             for b in blobs]
    header = json.dumps({"skeleton": skeleton, "arrays": sizes}).encode()
    parts: List[Any] = [struct.pack("<I", len(header)), header]
    for b in blobs:
        if isinstance(b, tuple):
            parts.extend(b)
        else:
            parts.append(b)
    return b"".join(parts)


# -- decode -------------------------------------------------------------------

class _Array:
    """A decoded array leaf before it becomes a tensor: a read-only numpy
    view of the message buffer, and the extension dtype it carries."""

    __slots__ = ("arr", "ext")

    def __init__(self, arr: np.ndarray, ext: str = ""):
        self.arr, self.ext = arr, ext


def _blob_at(blobs: List[Any], idx: Any) -> Any:
    try:
        i = int(idx)
    except (TypeError, ValueError):
        raise ValueError(f"non-integer blob index {idx!r}") from None
    if not 0 <= i < len(blobs):
        raise ValueError(f"payload references blob {i} of {len(blobs)}")
    return blobs[i]


_NPY_MAGIC = b"\x93NUMPY"


def _ndarray_from_npy(mv: memoryview) -> np.ndarray:
    """One ``.npy`` blob as a read-only view of the buffer (the reference's
    parser: every malformed or truncated blob raises ``ValueError``)."""
    head = mv[: min(len(mv), 12)].tobytes()
    if head[:6] != _NPY_MAGIC:
        raise ValueError("array blob is not in npy format")
    if len(head) < 10:
        raise ValueError("array blob header is truncated")
    if head[6] == 1:
        (hlen,) = struct.unpack_from("<H", head, 8)
        data_start = 10 + hlen
        header_fn = np.lib.format.read_array_header_1_0
    else:
        if len(head) < 12:
            raise ValueError("array blob header is truncated")
        (hlen,) = struct.unpack_from("<I", head, 8)
        data_start = 12 + hlen
        header_fn = np.lib.format.read_array_header_2_0
    shape, fortran_order, dtype = header_fn(io.BytesIO(mv[8:data_start].tobytes()))
    if dtype.hasobject:
        raise ValueError("object arrays are not allowed in safe payloads")
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    nbytes = count * dtype.itemsize
    data = mv[data_start:data_start + nbytes]
    if len(data) != nbytes:
        raise ValueError("array blob is truncated")
    arr = np.frombuffer(data, dtype=dtype, count=count)
    return arr.reshape(shape, order="F" if fortran_order else "C")


def _structure_keys(structure: Any, n_leaves: int) -> tuple:
    """The reference's structure node (each leaf's index, nested by key) →
    the port's flat keys in index order."""
    flat: Dict[int, str] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, int) and not isinstance(node, bool):
            if node in flat:
                raise ValueError("compressed payload structure repeats a leaf")
            flat[node] = prefix
        elif node != []:  # an empty tree is an empty list in the reference
            raise ValueError("compressed payload structure must be a nested "
                             f"dict of leaf indices, got {type(node).__name__}")

    walk(structure, "")
    if sorted(flat) != list(range(n_leaves)):
        raise ValueError("compressed payload structure does not index its leaves")
    return tuple(flat[i] for i in range(n_leaves))


def _decode_codec(node: dict, blobs: List[memoryview]) -> Any:
    """Rebuild a CompressedTree from its tagged node; unknown tags and wire
    versions raise ``ValueError``, as in the reference."""
    from fedml_tpu_torch.compression.codecs import (
        MASKABLE_CODECS,
        WIRE_VERSION,
        WIRE_VERSION_MASKED,
        CompressedTree,
        available_codecs,
    )

    codec = node.get(_CODEC)
    if not isinstance(codec, str) or codec not in available_codecs():
        raise ValueError(f"unknown compression codec tag {codec!r}")
    version = node.get("v")
    if version not in (WIRE_VERSION, WIRE_VERSION_MASKED):
        raise ValueError(f"unsupported compression wire version {version!r}")
    if version == WIRE_VERSION_MASKED:
        if codec not in MASKABLE_CODECS:
            raise ValueError(f"codec {codec!r} is not maskable; v2 wire nodes "
                             "carry masked payloads only")
        raise NotImplementedError(
            "masked secure-aggregation payloads come with the trust stack "
            "(ROADMAP A10.2); the port has not ported it yet")
    if "sa" in node:
        raise ValueError("v1 compressed payload carries a masked sa field")
    meta = node.get("meta")
    arrays = _decode(node.get("state"), blobs)
    if not isinstance(meta, list) or not isinstance(arrays, list):
        raise ValueError("malformed compressed payload")
    try:
        meta_t = tuple((str(dt), tuple(int(d) for d in sh)) for dt, sh in meta)
        if not all(isinstance(p, list) for p in arrays):
            raise ValueError("compressed payload state is not a list of lists")
        keys = _structure_keys(_decode(node.get("structure"), blobs), len(meta_t))
        return CompressedTree(codec, int(version), bool(node.get("delta", False)),
                              int(node.get("raw_nbytes", 0)), meta_t, keys, arrays)
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed compressed payload: {e}") from None


def _decode(node: Any, blobs: List[memoryview]) -> Any:
    if isinstance(node, dict):
        if _CODEC in node:
            return _decode_codec(node, blobs)
        if _ARRAY in node and (len(node) == 1 or (len(node) == 2 and "dt" in node)):
            raw = _blob_at(blobs, node[_ARRAY])
            if raw[:4].tobytes() == b"RAW0":
                raise ValueError("array tag references a bytes blob")
            arr = _ndarray_from_npy(raw)
            dt = node.get("dt")
            if dt is None:
                return _Array(arr)
            if dt not in _EXT_DTYPES:
                raise ValueError(f"unknown extension dtype tag {dt!r}")
            if arr.dtype != _EXT_DTYPES[dt]:
                raise ValueError(f"extension dtype tag {dt!r} on a {arr.dtype} blob")
            return _Array(arr, dt)
        if _BYTES in node and len(node) == 1:
            raw = _blob_at(blobs, node[_BYTES])
            if raw[:4].tobytes() != b"RAW0":
                raise ValueError("bytes tag references a non-bytes blob")
            return raw[4:].tobytes()
        if node.get(_TUPLE) == "tuple":
            if not isinstance(node.get("items"), list):
                raise ValueError("malformed tuple node")
            return tuple(_decode(v, blobs) for v in node["items"])
        if node.get(_TUPLE) == "dict_items":
            items = node.get("items")
            if not isinstance(items, list) or not all(
                    isinstance(kv, list) and len(kv) == 2 for kv in items):
                raise ValueError("malformed dict_items node")
            try:
                return {_decode(k, blobs): _decode(v, blobs) for k, v in items}
            except TypeError as e:  # an unhashable key
                raise ValueError(f"malformed dict_items key: {e}") from None
        return {k: _decode(v, blobs) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(v, blobs) for v in node]
    return node


def _collect_arrays(obj: Any, out: List[_Array]) -> None:
    from fedml_tpu_torch.compression.codecs import CompressedTree

    if isinstance(obj, _Array):
        out.append(obj)
    elif isinstance(obj, CompressedTree):
        _collect_arrays(obj.arrays, out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _collect_arrays(k, out)
            _collect_arrays(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_arrays(v, out)


def _materialize(arrays: List[_Array], device: torch.device) -> Dict[int, torch.Tensor]:
    """Each decoded array → a tensor on ``device``, copied once: into its own
    CPU tensor, or on the card through one pinned staging buffer and one
    host-to-device copy (the leaves are views of the device buffer)."""
    specs = []
    for a in arrays:
        dtype = torch.bfloat16 if a.ext == "bfloat16" else _torch_dtype(a.arr.dtype)
        specs.append((dtype, tuple(a.arr.shape), a.arr.nbytes))
    if device.type == "cpu":
        out = {}
        for a, (dtype, shape, _) in zip(arrays, specs):
            t = torch.empty(shape, dtype=dtype)
            np.copyto(_np_view(t), a.arr, casting="no")
            out[id(a)] = t
        return out
    total = sum(_aligned(n) for _, _, n in specs)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    offsets, off = [], 0
    for a, (dtype, shape, n) in zip(arrays, specs):
        np.copyto(_np_view(host[off:off + n].view(dtype).view(shape)), a.arr,
                  casting="no")
        offsets.append(off)
        off += _aligned(n)
    dev = host.to(device, non_blocking=True)
    return {id(a): dev[o:o + n].view(dtype).view(shape)
            for a, o, (dtype, shape, n) in zip(arrays, offsets, specs)}


def _replace(obj: Any, tensors: Dict[int, torch.Tensor]) -> Any:
    from fedml_tpu_torch.compression.codecs import CompressedTree

    if isinstance(obj, _Array):
        return tensors[id(obj)]
    if isinstance(obj, CompressedTree):
        obj.arrays = _replace(obj.arrays, tensors)
        return obj
    if isinstance(obj, dict):
        return {_replace(k, tensors): _replace(v, tensors) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_replace(v, tensors) for v in obj)
    if isinstance(obj, list):
        return [_replace(v, tensors) for v in obj]
    return obj


def safe_loads(data: Union[bytes, bytearray, memoryview],
               device: DeviceLike = "cpu") -> Any:
    """Decode a payload; its arrays become tensors on ``device``. Hostile or
    truncated payloads raise ``ValueError``."""
    if len(data) < 4:
        raise ValueError("payload too short for a header")
    (hlen,) = struct.unpack_from("<I", data, 0)
    if 4 + hlen > len(data):
        raise ValueError("header length overruns the payload")
    try:
        header = json.loads(bytes(data[4:4 + hlen]).decode())
    except UnicodeDecodeError as e:
        raise ValueError(f"payload header is not UTF-8: {e}") from None
    if not isinstance(header, dict) or not isinstance(header.get("arrays"), list):
        raise ValueError("malformed payload header")
    offset = 4 + hlen
    mv = memoryview(data)
    blobs: List[memoryview] = []
    for nbytes in header["arrays"]:
        nbytes = _blob_size(nbytes)
        if offset + nbytes > len(data):
            raise ValueError("blob table overruns the payload")
        blobs.append(mv[offset:offset + nbytes])
        offset += nbytes
    obj = _decode(header["skeleton"], blobs)
    arrays: List[_Array] = []
    _collect_arrays(obj, arrays)
    if not arrays:
        return obj
    return _replace(obj, _materialize(arrays, torch.device(device)))


def _blob_size(nbytes: Any) -> int:
    try:
        n = int(nbytes)
    except (TypeError, ValueError):
        raise ValueError(f"non-integer blob size {nbytes!r}") from None
    if n < 0:
        raise ValueError(f"negative blob size {n}")
    return n


def tree_nbytes(tree: Any) -> int:
    """Bytes of a payload's array leaves (a compressed tree's encoded
    arrays), read from metadata: no device-to-host copy."""
    from fedml_tpu_torch.compression.codecs import CompressedTree

    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, CompressedTree):
        return tree_nbytes(tree.arrays)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    nb = getattr(tree, "nbytes", None)
    return int(nb) if nb is not None else np.asarray(tree).nbytes
