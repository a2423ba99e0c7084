"""tiktoken-compatible Python facade over the C++ BPE core.

Exposes the subset of ``tiktoken.Encoding`` the tokenizer stack actually uses
(ssi_jax/tokenizer/__init__.py): ordinary text encode with specials disabled,
decode, and ``n_vocab``. Special tokens never reach the native core — encode
is always called with specials disallowed (user data containing special-token
strings is encoded as plain text, same policy as the reference), and decode
splices special strings around native calls for the base-vocab runs.

Bit-identity with tiktoken is the contract, enforced by differential fuzzing
in tests/test_native_bpe.py (the reference's DSU pipeline depends on exact
token streams — ref: ssi/tokenizer/monkeypatch.py:7).
"""

from __future__ import annotations

import ctypes

from ssi_jax.native import load_native

__all__ = ["NativeEncoding", "available"]

_bound = False


def _lib() -> ctypes.CDLL | None:
    global _bound
    lib = load_native()
    if lib is not None and not _bound:
        c = ctypes
        lib.bpe_last_error.restype = c.c_char_p
        lib.bpe_new.argtypes = [c.c_char_p]
        lib.bpe_new.restype = c.c_void_p
        lib.bpe_free.argtypes = [c.c_void_p]
        lib.bpe_n_vocab.argtypes = [c.c_void_p]
        lib.bpe_n_vocab.restype = c.c_int64
        lib.bpe_encode.argtypes = [
            c.c_void_p, c.c_char_p, c.c_int64,
            c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.c_int64),
        ]
        lib.bpe_encode.restype = c.c_int
        lib.bpe_free_i32.argtypes = [c.POINTER(c.c_int32)]
        lib.bpe_decode.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.c_int64,
            c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
        ]
        lib.bpe_decode.restype = c.c_int
        lib.bpe_free_u8.argtypes = [c.POINTER(c.c_uint8)]
        _bound = True
    return lib


def available() -> bool:
    return _lib() is not None


class NativeEncoding:
    """Loads a tiktoken ``tokenizer.model`` merges file into the C++ core.

    Args:
        path: merges file ("<base64> <rank>" lines).
        special_tokens: special string -> id (ids at/above the base vocab).
    """

    def __init__(self, path: str, special_tokens: dict[str, int] | None = None):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native BPE library unavailable")
        self._lib = lib
        self._handle = lib.bpe_new(str(path).encode())
        if not self._handle:
            raise OSError(f"BPE load failed: {lib.bpe_last_error().decode()}")
        self._base_vocab = int(lib.bpe_n_vocab(self._handle))
        self.special_tokens = dict(special_tokens or {})
        self._special_by_id = {v: k for k, v in self.special_tokens.items()}

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.bpe_free(handle)

    @property
    def n_vocab(self) -> int:
        if self.special_tokens:
            return max(self._base_vocab, max(self.special_tokens.values()) + 1)
        return self._base_vocab

    def encode(self, text: str, allowed_special=frozenset(), disallowed_special=()) -> list[int]:
        """Ordinary encode — special-token *strings* in the text are plain text."""
        if allowed_special:
            raise NotImplementedError("native encode supports allowed_special=set() only")
        data = text.encode("utf-8")
        c = ctypes
        out = c.POINTER(c.c_int32)()
        out_len = c.c_int64()
        rc = self._lib.bpe_encode(self._handle, data, len(data), c.byref(out), c.byref(out_len))
        if rc != 0:
            raise RuntimeError(self._lib.bpe_last_error().decode())
        try:
            return out[: out_len.value]
        finally:
            self._lib.bpe_free_i32(out)

    def _decode_base_run(self, ids: list[int]) -> bytes:
        if not ids:
            return b""
        c = ctypes
        arr = (c.c_int32 * len(ids))(*ids)
        out = c.POINTER(c.c_uint8)()
        out_len = c.c_int64()
        rc = self._lib.bpe_decode(self._handle, arr, len(ids), c.byref(out), c.byref(out_len))
        if rc != 0:
            raise KeyError(self._lib.bpe_last_error().decode())
        try:
            return bytes(out[: out_len.value])
        finally:
            self._lib.bpe_free_u8(out)

    def decode_bytes(self, token_ids: list[int]) -> bytes:
        parts: list[bytes] = []
        run: list[int] = []
        for t in token_ids:
            if t in self._special_by_id:
                parts.append(self._decode_base_run(run))
                run = []
                parts.append(self._special_by_id[t].encode("utf-8"))
            else:
                run.append(int(t))
        parts.append(self._decode_base_run(run))
        return b"".join(parts)

    def decode(self, token_ids: list[int], errors: str = "replace") -> str:
        return self.decode_bytes(token_ids).decode("utf-8", errors=errors)
