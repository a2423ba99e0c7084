"""First-party C++ native layer: safetensors interop with the upstream Rust crate.

The native serializer replaces a *format contract*, so the tests are
differential: every file our writer produces must be readable by the upstream
``safetensors`` package with identical contents, and vice versa
(ref dependency being replaced: safetensors Rust crate, used by
ssi/checkpoint.py:339-410 via safetensors.torch).
"""

import struct

import ml_dtypes
import numpy as np
import pytest

from ssi_jax.native import safetensors_io as stio

pytestmark = pytest.mark.skipif(not stio.available(), reason="no C++ toolchain")


@pytest.fixture()
def tensors():
    rng = np.random.default_rng(0)
    return {
        "model.layers.0.weight": rng.standard_normal((3, 5)).astype(np.float32),
        "bias": rng.standard_normal((7,)).astype(np.float16),
        "bf16.block": rng.standard_normal((4, 4)).astype(ml_dtypes.bfloat16),
        "ints": rng.integers(0, 100, (2, 3, 4)).astype(np.int64),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(3.5, np.float32),
        "unicode éß name": np.arange(6, dtype=np.uint8),
        'quote"backslash\\name': np.arange(3, dtype=np.int32),
    }


def _bytes_of(v):
    return np.ascontiguousarray(v).tobytes()


def test_upstream_reads_our_file(tensors, tmp_path):
    import safetensors

    path = tmp_path / "ours.safetensors"
    stio.save_file(tensors, str(path), metadata={"format": "pt"})
    with safetensors.safe_open(str(path), framework="np") as f:
        assert set(f.keys()) == set(tensors)
        assert f.metadata() == {"format": "pt"}
        for k, want in tensors.items():
            got = f.get_tensor(k)
            assert got.shape == want.shape, k
            assert got.tobytes() == _bytes_of(want), k


def test_we_read_upstream_file(tensors, tmp_path):
    from safetensors.numpy import save_file as upstream_save

    path = tmp_path / "theirs.safetensors"
    # upstream numpy writer takes bf16 as a uint16 view (no numpy bf16 dtype)
    upstream_save(
        {k: (v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 else v) for k, v in tensors.items()},
        str(path),
        metadata={"a": "b"},
    )
    f = stio.safe_open(str(path))
    assert set(f.keys()) == set(tensors)
    assert f.metadata() == {"a": "b"}
    for k, want in tensors.items():
        got = f.get_tensor(k)
        if want.dtype == ml_dtypes.bfloat16:
            want = want.view(np.uint16)
        assert got.shape == want.shape and got.tobytes() == _bytes_of(want), k


def test_own_round_trip_preserves_dtype(tensors, tmp_path):
    path = tmp_path / "rt.safetensors"
    stio.save_file(tensors, str(path))
    loaded = stio.load_file(str(path))
    for k, want in tensors.items():
        assert loaded[k].dtype == want.dtype
        assert loaded[k].shape == want.shape
        assert loaded[k].tobytes() == _bytes_of(want)


def test_zero_copy_views_outlive_handle(tmp_path):
    import gc

    path = tmp_path / "v.safetensors"
    want = np.arange(1024, dtype=np.float32)
    stio.save_file({"x": want}, str(path))
    arr = stio.load_file(str(path))["x"]  # handle goes out of scope here
    gc.collect()
    assert arr.sum() == want.sum()


def test_header_is_8_byte_aligned(tensors, tmp_path):
    path = tmp_path / "align.safetensors"
    stio.save_file(tensors, str(path))
    raw = path.read_bytes()
    (hlen,) = struct.unpack("<Q", raw[:8])
    assert (8 + hlen) % 8 == 0


def test_missing_file_and_missing_tensor(tmp_path):
    with pytest.raises(OSError):
        stio.safe_open(str(tmp_path / "nope.safetensors"))
    path = tmp_path / "one.safetensors"
    stio.save_file({"x": np.zeros(3, np.float32)}, str(path))
    f = stio.safe_open(str(path))
    with pytest.raises(KeyError):
        f.get_tensor("y")


def test_corrupt_files_rejected(tmp_path):
    short = tmp_path / "short.safetensors"
    short.write_bytes(b"\x01\x02")
    with pytest.raises(OSError):
        stio.safe_open(str(short))

    # header length pointing past EOF
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
    with pytest.raises(OSError):
        stio.safe_open(str(bad))

    # offsets exceeding the data section
    evil = tmp_path / "evil.safetensors"
    header = b'{"x":{"dtype":"F32","shape":[4],"data_offsets":[0,16]}}'
    evil.write_bytes(struct.pack("<Q", len(header)) + header + b"\x00" * 8)  # only 8 data bytes
    with pytest.raises(OSError):
        stio.safe_open(str(evil))

    # duplicate tensor name: must be a clean parse error, not last-one-wins
    dup = tmp_path / "dup.safetensors"
    header = (
        b'{"x":{"dtype":"F32","shape":[1],"data_offsets":[0,4]},'
        b'"x":{"dtype":"F32","shape":[1],"data_offsets":[4,8]}}'
    )
    dup.write_bytes(struct.pack("<Q", len(header)) + header + b"\x00" * 8)
    with pytest.raises(OSError, match="duplicate"):
        stio.safe_open(str(dup))

    # numel * itemsize overflowing int64 must be a clean parse error
    huge = tmp_path / "huge.safetensors"
    header = b'{"x":{"dtype":"F32","shape":[3037000500,3037000500],"data_offsets":[0,8]}}'
    huge.write_bytes(struct.pack("<Q", len(header)) + header + b"\x00" * 8)
    with pytest.raises(OSError, match="overflow"):
        stio.safe_open(str(huge))


def test_checkpoint_backend_env_switch(monkeypatch):
    from ssi_jax.checkpoint import _safetensors_backend

    native_open, native_save = _safetensors_backend()
    assert native_open is stio.safe_open and native_save is stio.save_file

    monkeypatch.setenv("SSI_JAX_NATIVE_SAFETENSORS", "0")
    up_open, up_save = _safetensors_backend()
    import safetensors
    import safetensors.numpy

    assert up_open is safetensors.safe_open and up_save is safetensors.numpy.save_file


def test_zero_copy_views_are_read_only(tmp_path):
    """In-place writes must raise (the view aliases a PROT_READ mmap — a
    writable flag would turn user mutation into a SIGSEGV)."""
    path = tmp_path / "ro.safetensors"
    stio.save_file({"x": np.arange(8, dtype=np.float32)}, str(path))
    arr = stio.load_file(str(path))["x"]
    assert not arr.flags.writeable
    with pytest.raises(ValueError):
        arr[0] = 1.0
