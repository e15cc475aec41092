"""Zero-copy safetensors reader/writer.

Counterpart of tinygpt_tpu/hf/safetensors_io.py: u64-length JSON header +
raw tensor data, single-file and sharded (`model.safetensors.index.json`
weight_map) loading, shape/dtype validation, a symmetric save, and
`match_state`, which checks loaded tensors against the names and shapes a
model expects.

Tensors are returned as CPU `torch.Tensor`s over an `np.memmap` of the
file — nothing is copied on the host; the model loader moves them to the
device. numpy has no bfloat16 or float8, so those are mapped as raw
uint16 / uint8 views and reinterpreted by torch (`Tensor.view(dtype)`),
which keeps the bytes exact without the `ml_dtypes` package.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("hf.safetensors")

# safetensors dtype string -> (numpy dtype the bytes are read as, torch
# dtype of the result)
_STR_TO_DTYPE = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "U16": (np.uint16, torch.uint16),
    "U32": (np.uint32, torch.uint32),
    "BOOL": (np.bool_, torch.bool),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (np.uint8, torch.float8_e5m2),
}
_DTYPE_TO_STR = {t: k for k, (_, t) in _STR_TO_DTYPE.items()}


class SafeTensorsError(ValueError):
    pass


def _read_header(path: str) -> Tuple[dict, int]:
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafeTensorsError(f"{path}: truncated header length")
        (header_len,) = struct.unpack("<Q", raw)
        if header_len > 100 * 1024 * 1024:
            raise SafeTensorsError(f"{path}: implausible header size {header_len}")
        header = json.loads(f.read(header_len))
    return header, 8 + header_len


def _as_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """CPU tensor over `arr`'s memory (no copy), reinterpreted as dtype.
    The mapping is read-only; torch warns about that once per call, and
    nothing here writes through it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t if t.dtype == dtype else t.view(dtype)


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Load one .safetensors file as a dict of zero-copy CPU tensors.

    The returned tensors alias a read-only np.memmap; callers copy them
    (to the device, or with .clone()) before writing.
    """
    header, data_offset = _read_header(path)
    header.pop("__metadata__", None)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        spec = _STR_TO_DTYPE.get(info["dtype"])
        if spec is None:
            raise SafeTensorsError(f"{path}: unsupported dtype {info['dtype']!r}")
        np_dtype, dtype = np.dtype(spec[0]), spec[1]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
        if end - begin != nbytes:
            raise SafeTensorsError(
                f"{path}: {name}: data_offsets span {end - begin} != "
                f"shape/dtype nbytes {nbytes}"
            )
        view = mm[data_offset + begin : data_offset + end].view(np_dtype)
        out[name] = _as_tensor(view, dtype).reshape(shape)
    return out


def load_safetensors_dir(model_dir: str) -> Dict[str, torch.Tensor]:
    """Load all weights from an HF model dir: either `model.safetensors` or
    the sharded `model.safetensors.index.json`. Arbitrary *.safetensors
    fallback included."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    single_path = os.path.join(model_dir, "model.safetensors")
    out: Dict[str, torch.Tensor] = {}
    if os.path.exists(index_path):
        with open(index_path, "r", encoding="utf-8") as f:
            index = json.load(f)
        weight_map: Dict[str, str] = index["weight_map"]
        by_shard: Dict[str, list] = {}
        for key, shard in weight_map.items():
            by_shard.setdefault(shard, []).append(key)
        for shard, keys in sorted(by_shard.items()):
            tensors = load_safetensors(os.path.join(model_dir, shard))
            for k in keys:
                if k not in tensors:
                    raise SafeTensorsError(f"{shard}: index promises {k!r}, absent")
                out[k] = tensors[k]
        return out
    if os.path.exists(single_path):
        return load_safetensors(single_path)
    shards = sorted(
        f for f in os.listdir(model_dir) if f.endswith(".safetensors")
    )
    if not shards:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    for shard in shards:
        out.update(load_safetensors(os.path.join(model_dir, shard)))
    return out


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a contiguous CPU uint8 array."""
    t = t.detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


def save_safetensors(
    path: str,
    tensors: Dict[str, torch.Tensor],
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write a .safetensors file. Takes torch tensors (any device) or numpy
    arrays of the dtypes numpy has."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    blobs = []
    for name, t in tensors.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        dt = _DTYPE_TO_STR.get(t.dtype)
        if dt is None:
            raise SafeTensorsError(f"{name}: unsupported dtype {t.dtype}")
        blob = _raw_bytes(t)
        header[name] = {
            "dtype": dt,
            "shape": list(t.shape),
            "data_offsets": [offset, offset + blob.nbytes],
        }
        blobs.append(blob)
        offset += blob.nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # pad header to 8-byte alignment so tensor data is aligned
    pad = (-(8 + len(hjson))) % 8
    hjson += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob.data)


def _shortlist(keys: list) -> str:
    return f"{keys[:8]}{'...' if len(keys) > 8 else ''}"


def match_state(
    loaded: Dict[str, torch.Tensor],
    expected: Dict[str, Tuple[tuple, Optional[torch.dtype]]],
    strict: bool = False,
    consume: Optional[Callable[[str, torch.Tensor], None]] = None,
) -> Tuple[list, list]:
    """Validate loaded tensors against an expected name -> (shape, dtype)
    map: a shape that differs raises; missing and unexpected names are
    logged, or raise under strict=True. `consume(name, tensor)` is called
    on each expected tensor that was loaded, in `expected`'s order, after
    its shape checked out. The dtype is not checked (the loader casts).

    Returns (missing_keys, unexpected_keys)."""
    missing = [k for k in expected if k not in loaded]
    unexpected = [k for k in loaded if k not in expected]
    for k, (shape, _dtype) in expected.items():
        if k not in loaded:
            continue
        t = loaded[k]
        if tuple(t.shape) != tuple(shape):
            raise SafeTensorsError(
                f"{k}: shape mismatch, file {tuple(t.shape)} vs model {tuple(shape)}"
            )
        if consume is not None:
            consume(k, t)
    for what, keys in (("missing", missing), ("unexpected", unexpected)):
        if keys:
            msg = f"{what} keys: {_shortlist(keys)}"
            if strict:
                raise SafeTensorsError(msg)
            log.warning(msg)
    return missing, unexpected
