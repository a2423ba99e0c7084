"""NumPy-facing API over the first-party C++ safetensors core.

Drop-in equivalents of the ``safetensors`` calls the checkpoint layer makes
(`safe_open(..., framework="np")` and `safetensors.numpy.save_file`; ref uses
the same library from torch — ref: ssi/checkpoint.py:339-410), backed by
``ssi_jax/native/src/safetensors.cc`` instead of the upstream Rust crate.

Reads are zero-copy: ``get_tensor`` returns an ndarray viewing the mmap'd
file. The view keeps the file handle alive through the ndarray base chain, so
(unlike upstream ``safe_open``) tensors stay valid after the context exits —
strictly more permissive than the contract the call sites rely on. bfloat16
round-trips through a uint16 view of ``ml_dtypes.bfloat16`` (NumPy itself has
no bf16 scalar type).

If the native library cannot be built (no toolchain), importing this module
still succeeds and ``available()`` returns False; callers fall back to the
upstream package.
"""

from __future__ import annotations

import ctypes
import json
from typing import Any, Mapping

import numpy as np

from ssi_jax.native import load_native

__all__ = ["available", "safe_open", "load_file", "save_file"]

_MAX_NDIM = 16

# safetensors dtype tag <-> numpy dtype. BF16 is handled out-of-band (uint16
# storage + ml_dtypes view) because np.dtype("bfloat16") does not exist.
_ST_TO_NP = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def _bf16():
    import ml_dtypes

    return ml_dtypes.bfloat16


def _np_to_st(dtype: np.dtype) -> str:
    if dtype == _bf16():
        return "BF16"
    for tag, np_t in _ST_TO_NP.items():
        if dtype == np.dtype(np_t):
            return tag
    raise ValueError(f"unsupported dtype for safetensors: {dtype}")


def available() -> bool:
    return load_native() is not None


def _lib() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        from ssi_jax.native import native_error

        raise RuntimeError(f"native safetensors unavailable: {native_error()}")
    return lib


class safe_open:
    """Context manager mirroring ``safetensors.safe_open(path, framework="np")``."""

    def __init__(self, path: str, framework: str = "np", device: str = "cpu"):
        if framework != "np":
            raise ValueError("native safe_open supports framework='np' only")
        lib = _lib()
        self._lib = lib
        self._handle = lib.st_open(str(path).encode())
        if not self._handle:
            raise OSError(f"safetensors open failed: {lib.st_last_error().decode()}")

    def __enter__(self) -> "safe_open":
        return self

    def __exit__(self, *exc) -> None:
        # The mmap must outlive any zero-copy tensors handed out; closing is
        # deferred to __del__ once all views (which hold a ref via _owner) die.
        pass

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.st_close(handle)

    def keys(self) -> list[str]:
        n = self._lib.st_n_tensors(self._handle)
        return [self._lib.st_tensor_name(self._handle, i).decode() for i in range(n)]

    def metadata(self) -> dict[str, str] | None:
        raw = self._lib.st_metadata_json(self._handle)
        return None if raw is None else json.loads(raw.decode())

    def get_tensor(self, name: str) -> np.ndarray:
        c = ctypes
        dtype_buf = c.create_string_buffer(16)
        ndim = c.c_int64()
        shape = (c.c_int64 * _MAX_NDIM)()
        data = c.POINTER(c.c_uint8)()
        nbytes = c.c_int64()
        rc = self._lib.st_tensor_info(
            self._handle, name.encode(), dtype_buf, c.byref(ndim), shape,
            _MAX_NDIM, c.byref(data), c.byref(nbytes),
        )
        if rc != 0:
            raise KeyError(f"{name}: {self._lib.st_last_error().decode()}")
        tag = dtype_buf.value.decode()
        dims = tuple(shape[i] for i in range(ndim.value))
        buf = (c.c_uint8 * nbytes.value).from_address(c.addressof(data.contents)) if nbytes.value else b""
        if nbytes.value:
            buf._owner = self  # keeps the mmap alive as long as the view lives
        if tag == "BF16":
            arr = np.frombuffer(buf, dtype=np.uint16).view(_bf16())
        else:
            if tag not in _ST_TO_NP:
                raise ValueError(f"unsupported dtype tag {tag} for tensor {name}")
            arr = np.frombuffer(buf, dtype=_ST_TO_NP[tag])
        # the view aliases a PROT_READ mmap: an in-place write would SIGSEGV,
        # so surface it as a normal numpy read-only error instead
        arr.flags.writeable = False
        return arr.reshape(dims)


def load_file(path: str) -> dict[str, np.ndarray]:
    f = safe_open(path, framework="np")
    return {k: f.get_tensor(k) for k in f.keys()}


def save_file(
    tensors: Mapping[str, np.ndarray], path: str, metadata: Mapping[str, str] | None = None
) -> None:
    """Write a safetensors file readable by the upstream Rust/Python readers."""
    lib = _lib()
    c = ctypes
    # NB: np.ascontiguousarray promotes 0-d to 1-d; 0-d arrays are always
    # contiguous, so only call it when actually needed.
    items: list[tuple[str, np.ndarray]] = []
    for k, v in tensors.items():
        arr = np.asarray(v)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        items.append((k, arr))
    n = len(items)
    names = (c.c_char_p * n)(*[k.encode() for k, _ in items])
    dtypes = (c.c_char_p * n)(*[_np_to_st(v.dtype).encode() for _, v in items])
    ndims = (c.c_int64 * n)(*[v.ndim for _, v in items])
    shapes_flat_list: list[int] = []
    for _, v in items:
        shapes_flat_list.extend(v.shape)
    shapes_flat = (c.c_int64 * max(1, len(shapes_flat_list)))(*shapes_flat_list)
    datas = (c.POINTER(c.c_uint8) * n)()
    nbytes = (c.c_int64 * n)()
    for i, (_, v) in enumerate(items):
        nbytes[i] = v.nbytes
        datas[i] = c.cast(v.ctypes.data, c.POINTER(c.c_uint8)) if v.nbytes else c.POINTER(c.c_uint8)()
    meta_json = (
        json.dumps(dict(metadata), separators=(",", ":"), ensure_ascii=False).encode()
        if metadata is not None
        else None
    )
    rc = lib.st_save(str(path).encode(), n, names, dtypes, ndims, shapes_flat, datas, nbytes, meta_json)
    if rc != 0:
        raise OSError(f"safetensors save failed: {lib.st_last_error().decode()}")


def as_numpy_state(tensors: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Coerce a mapping of array-likes to contiguous host ndarrays."""
    return {k: np.ascontiguousarray(np.asarray(v)) for k, v in tensors.items()}
