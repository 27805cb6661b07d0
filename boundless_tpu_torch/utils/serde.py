"""Safe wire formats for images and receipts, on torch.

The port's copy of `boundless_tpu/utils/serde.py` (reference role: the
bincode (de)serialization of Segment/Receipt, SURVEY §2.4c). Pickle is
never used for untrusted input: the REST API accepts guest images in the
versioned binary format below (magic + version + entry + sorted
(addr, word) u32-LE pairs), and receipts round-trip through a structured
numpy-aware container.

Formats:
  image v1:  b"BTIM" u32(version=1) u32(entry) u32(count) count*(u32,u32)
  pytree v1: JSON header {version, treedef-ish spec} + concatenated raw
             little-endian array payloads.

The bytes a port object dumps to equal the bytes of the JAX package's
object it converts to (`boundless_tpu_torch/convert.py`). The port keeps
field words and p254 digests in `torch.int32` tensors, where the JAX
objects hold uint32 arrays of the same bits, so an int32 tensor is written
as a uint32 array (`_host_array`); numpy arrays are written with their own
dtype, as JAX writes them. Tensors on the card are copied to the host
first. On load, the arrays of the prover's named tuples (`SegmentProof`,
`GroupOpening`, `FriProof`) become int32 tensors on the `device` the
caller names; every other array stays numpy, as in the reference.
`to_cpu` moves every tensor of an object to the CPU (the object store and
the data plane use it, so a file written on the card loads in a process
without one); `to_device` moves them to any device (the market's seal
verifiers use it to check a stored receipt on the card).
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

IMAGE_MAGIC = b"BTIM"
IMAGE_VERSION = 1

# the prover's named tuples, whose arrays load as int32 tensors
_TENSOR_CLASSES = ("SegmentProof", "GroupOpening", "FriProof")


class SerdeError(Exception):
    pass


def dump_image(image) -> bytes:
    items = sorted(image.words.items())
    out = [IMAGE_MAGIC, struct.pack("<II", IMAGE_VERSION, image.entry),
           struct.pack("<I", len(items))]
    for addr, word in items:
        out.append(struct.pack("<II", addr, word))
    return b"".join(out)


def load_image(data: bytes):
    from ..zkvm.executor import MemoryImage

    if data[:4] != IMAGE_MAGIC:
        raise SerdeError("bad image magic")
    version, entry = struct.unpack_from("<II", data, 4)
    if version != IMAGE_VERSION:
        raise SerdeError(f"unsupported image version {version}")
    (count,) = struct.unpack_from("<I", data, 12)
    if len(data) != 16 + 8 * count:
        raise SerdeError("truncated image payload")
    words = {}
    off = 16
    for _ in range(count):
        addr, word = struct.unpack_from("<II", data, off)
        words[addr] = word
        off += 8
    return MemoryImage(words=words, entry=entry)


# ---------------------------------------------------------------------------
# Tensors to the host
# ---------------------------------------------------------------------------


def to_device(obj, device):
    """`obj` with every torch tensor in it moved to `device`: a walk over
    named tuples, dataclasses, tuples, lists and dicts (the port's stand-in
    for `jax.tree_util.tree_map`). An object whose tensors all lie on
    `device` comes back as it is; `torch.device("cuda")` takes a tensor on
    any card as already there."""
    dev = torch.device(device)
    if isinstance(obj, torch.Tensor):
        here = obj.device.type == dev.type and (
            dev.index is None or obj.device.index == dev.index)
        return obj if here else obj.detach().to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        vals = [to_device(v, dev) for v in obj]
        if all(a is b for a, b in zip(vals, obj)):
            return obj
        return type(obj)(*vals)
    if isinstance(obj, (list, tuple)):
        vals = [to_device(v, dev) for v in obj]
        if all(a is b for a, b in zip(vals, obj)):
            return obj
        return type(obj)(vals)
    if isinstance(obj, dict):
        vals = {k: to_device(v, dev) for k, v in obj.items()}
        if all(vals[k] is v for k, v in obj.items()):
            return obj
        return vals
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changed = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            w = to_device(v, dev)
            if w is not v:
                changed[f.name] = w
        return dataclasses.replace(obj, **changed) if changed else obj
    return obj


def to_cpu(obj):
    """`obj` with every torch tensor in it moved to the CPU."""
    return to_device(obj, "cpu")


def _host_array(obj) -> np.ndarray:
    """An array leaf as the JAX package writes it: a torch int32 tensor
    (field words, p254 digest words) as uint32 of the same bits, on the
    host; numpy and other values as `np.asarray` gives them."""
    if isinstance(obj, torch.Tensor):
        arr = obj.detach().cpu().numpy()
        return arr.view(np.uint32) if arr.dtype == np.int32 else arr
    return np.asarray(obj)


# ---------------------------------------------------------------------------
# Array-pytree container (receipts)
# ---------------------------------------------------------------------------


def _encode(obj, arrays):
    """Encode into JSON-able spec; numeric arrays appended to `arrays`."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "scalar", "v": obj}
    if isinstance(obj, (np.integer, np.floating)):
        return {"t": "scalar",
                "v": int(obj) if isinstance(obj, np.integer) else float(obj)}
    if isinstance(obj, bytes):
        return {"t": "bytes", "v": obj.hex()}
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {"t": "dict",
                    "v": {k: _encode(v, arrays) for k, v in obj.items()}}
        if obj and all(isinstance(k, int) and isinstance(v, int)
                       and 0 <= k < 2**64 and 0 <= v < 2**64
                       for k, v in obj.items()):
            # int->int maps (memory word stores): two packed u64 columns
            idx = len(arrays)
            kv = np.array([[k, v] for k, v in sorted(obj.items())],
                          dtype=np.uint64)
            arrays.append(np.ascontiguousarray(kv))
            return {"t": "dictii", "i": idx, "dtype": "uint64",
                    "shape": list(kv.shape)}
        # other non-string keys: pair list
        return {"t": "dictp",
                "v": [[_encode(k, arrays), _encode(v, arrays)]
                      for k, v in obj.items()]}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {"t": "ntuple", "cls": type(obj).__name__,
                "v": {f: _encode(getattr(obj, f), arrays)
                      for f in obj._fields}}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode(x, arrays) for x in obj]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"t": "dclass", "cls": type(obj).__name__,
                "v": {f.name: _encode(getattr(obj, f.name), arrays)
                      for f in dataclasses.fields(obj)}}
    arr = _host_array(obj)
    if arr.dtype.kind in "uif":
        idx = len(arrays)
        arrays.append(np.ascontiguousarray(arr))
        return {"t": "array", "i": idx, "dtype": str(arr.dtype),
                "shape": list(arr.shape)}
    raise SerdeError(f"cannot serialize {type(obj)!r}")


def _tensors(obj, device):
    """The arrays of a prover named tuple's field as int32 tensors (a
    nested named tuple was decoded, and converted, on its own)."""
    if isinstance(obj, np.ndarray):
        arr = obj.view(np.int32) if obj.dtype == np.uint32 else obj
        return torch.from_numpy(arr.copy()).to(device)
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(_tensors(x, device) for x in obj)
    return obj


def _decode(spec, payload, registry, device):
    t = spec["t"]
    if t == "none":
        return None
    if t == "scalar":
        return spec["v"]
    if t == "bytes":
        return bytes.fromhex(spec["v"])
    if t == "dict":
        return {k: _decode(v, payload, registry, device)
                for k, v in spec["v"].items()}
    if t == "dictp":
        return {_decode(k, payload, registry, device):
                _decode(v, payload, registry, device) for k, v in spec["v"]}
    if t == "dictii":
        raw, dtype, shape = payload[spec["i"]]
        kv = np.frombuffer(raw, dtype=dtype).reshape(shape)
        return {int(k): int(v) for k, v in kv}
    if t in ("ntuple", "dclass"):
        cls = registry.get(spec["cls"])
        fields = {k: _decode(v, payload, registry, device)
                  for k, v in spec["v"].items()}
        if cls is None:
            if t == "dclass":
                raise SerdeError(f"unknown dataclass {spec['cls']!r}")
            return fields
        if spec["cls"] in _TENSOR_CLASSES:
            fields = {k: _tensors(v, device) for k, v in fields.items()}
        return cls(**fields)
    if t in ("list", "tuple"):
        seq = [_decode(x, payload, registry, device) for x in spec["v"]]
        return seq if t == "list" else tuple(seq)
    if t == "array":
        raw, dtype, shape = payload[spec["i"]]
        return np.frombuffer(raw, dtype=dtype).reshape(shape)
    raise SerdeError(f"bad spec {t!r}")


def dump_pytree(obj) -> bytes:
    arrays = []
    spec = _encode(obj, arrays)
    metas = []
    blobs = []
    for arr in arrays:
        raw = arr.tobytes()
        metas.append({"dtype": str(arr.dtype), "shape": list(arr.shape),
                      "size": len(raw)})
        blobs.append(raw)
    header = json.dumps({"version": 1, "spec": spec,
                         "arrays": metas}).encode()
    return (b"BTPT" + struct.pack("<I", len(header)) + header
            + b"".join(blobs))


def load_pytree(data: bytes, registry=None, device="cpu"):
    """Decode a pytree; the prover's named tuples get int32 tensors on
    `device`."""
    if data[:4] != b"BTPT":
        raise SerdeError("bad pytree magic")
    if len(data) < 8:
        raise SerdeError("truncated pytree header")
    (hlen,) = struct.unpack_from("<I", data, 4)
    if len(data) < 8 + hlen:
        raise SerdeError("truncated pytree header")
    try:
        header = json.loads(data[8 : 8 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SerdeError(f"malformed pytree header: {e}") from e
    if header["version"] != 1:
        raise SerdeError("unsupported pytree version")
    payload = []
    off = 8 + hlen
    for meta in header["arrays"]:
        raw = data[off : off + meta["size"]]
        if len(raw) != meta["size"]:
            raise SerdeError("truncated array payload")
        payload.append((raw, meta["dtype"], tuple(meta["shape"])))
        off += meta["size"]
    return _decode(header["spec"], payload, registry or default_registry(),
                   torch.device(device))


def default_registry():
    """Whitelist of wire-decodable classes (never arbitrary imports): the
    port's own classes under the reference's names."""
    from ..prover.stark import SegmentProof, GroupOpening
    from ..core.fri import FriProof
    from ..recursion.claims import Claim
    from ..recursion.succinct import RecReceipt, SuccinctSessionReceipt
    from ..recursion.receipt import SpanClaim, SuccinctReceipt, SessionReceipt
    from ..zkvm.executor import MemoryImage, Segment
    from ..zkvm.prove import SegmentReceipt

    return {"SegmentProof": SegmentProof, "GroupOpening": GroupOpening,
            "FriProof": FriProof, "Claim": Claim, "RecReceipt": RecReceipt,
            "SuccinctSessionReceipt": SuccinctSessionReceipt,
            "SpanClaim": SpanClaim, "SuccinctReceipt": SuccinctReceipt,
            "SessionReceipt": SessionReceipt, "Segment": Segment,
            "SegmentReceipt": SegmentReceipt, "MemoryImage": MemoryImage}


# ---------------------------------------------------------------------------
# Versioned object wire format (receipts / segments across processes)
# ---------------------------------------------------------------------------

OBJ_VERSION = 1


def dump_obj(obj, kind: str) -> bytes:
    """Versioned binary encoding of a registry object (reference role:
    bincode Segment/SuccinctReceipt/Receipt encodings, SURVEY §2.4c).

    Tensors are pulled to the host by `_encode`, so the payload is pure
    numpy wherever the proof lives."""
    return dump_pytree({"kind": kind, "version": OBJ_VERSION, "obj": obj})


def load_obj(data: bytes, kind: str = None, device="cpu"):
    """Decode a dump_obj payload (proof tensors on `device`); checks kind
    when given."""
    d = load_pytree(data, device=device)
    if not isinstance(d, dict) or "kind" not in d:
        raise SerdeError("not a versioned object payload")
    if d.get("version") != OBJ_VERSION:
        raise SerdeError(f"unsupported object version {d.get('version')}")
    if kind is not None and d["kind"] != kind:
        raise SerdeError(f"expected kind {kind!r}, got {d['kind']!r}")
    return d["obj"]


def dump_session_receipt(receipt) -> bytes:
    """SessionReceipt (v1 aggregation) or SuccinctSessionReceipt -> wire."""
    return dump_obj(receipt, "session_receipt")


def load_session_receipt(data: bytes, device="cpu"):
    return load_obj(data, "session_receipt", device)


def dump_segment(segment) -> bytes:
    return dump_obj(segment, "segment")


def load_segment(data: bytes):
    return load_obj(data, "segment")


def dump_segment_receipt(receipt) -> bytes:
    return dump_pytree({
        "kind": "segment_receipt", "version": 1,
        "proof": to_cpu(receipt.proof),
        "pub": receipt.pub,
        "image_id": _host_array(receipt.image_id),
        "po2": receipt.po2,
    })


def load_segment_receipt(data: bytes, device="cpu"):
    from ..zkvm.prove import SegmentReceipt

    d = load_pytree(data, device=device)
    if d.get("kind") != "segment_receipt":
        raise SerdeError("not a segment receipt")
    return SegmentReceipt(proof=d["proof"], pub=d["pub"],
                          image_id=d["image_id"], po2=int(d["po2"]))
