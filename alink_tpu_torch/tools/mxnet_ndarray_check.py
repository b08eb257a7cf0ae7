"""Independent second decoder for ``mx.nd.save`` checkpoint files
(counterpart of ``alink_tpu/tools/mxnet_ndarray_check.py``).

Purpose: break the fixture circularity around
``tools/convert_mxnet.read_mxnet_ndarray_file`` (the consumer the
reference loads through is ``code/face_model.py:34``).  That reader and
the test-suite fixture *writer* were derived from the same understanding
of the format, so a shared misreading would pass silently.  This module
re-derives the format from MXNet's documented serialization layout
alone — ``src/c_api/c_api.cc`` (MXNDArraySave: uint64 list magic 0x112 +
uint64 reserved), ``src/ndarray/ndarray.cc`` (NDArray::Save: uint32
version magic, int32 storage type for >=V2, TShape, int32 context
dev_type/dev_id, int32 type_flag, raw payload), nnvm ``TShape::Save``
(uint32 ndim + int64 dims; pre-magic legacy files stored uint32 dims),
and dmlc-core's vector/string stream serialization (uint64 count; each
string as uint64 length + bytes) — and deliberately shares no code,
helpers, or internal conventions with the primary reader:

- it parses through a strict bounded cursor that raises ``ValueError``
  on ANY truncation or overrun (the primary indexes a flat buffer with
  ``struct.unpack_from``);
- it validates every field it reads (list magic, reserved word, storage
  type, ndim bound, non-negative dims, known dtype code, payload bounds,
  name/array count agreement) instead of trusting the file;
- it preserves the stored dtype (the primary casts to float32 for the
  converter pipeline).

``tests/test_torch_port_tools.py`` holds both decoders to the JAX
package's on randomized checkpoints and malformed headers.
"""

from __future__ import annotations

import struct

import numpy as np

_LIST_MAGIC = 0x112
_BLOB_MAGIC_V1 = 0xF993FAC8
_BLOB_MAGIC_V2 = 0xF993FAC9
_BLOB_MAGIC_V3 = 0xF993FACA

# mshadow type_flag codes (mshadow/base.h).
_TYPE_FLAGS = {
    0: np.dtype("<f4"), 1: np.dtype("<f8"), 2: np.dtype("<f2"),
    3: np.dtype("u1"), 4: np.dtype("<i4"), 5: np.dtype("i1"),
    6: np.dtype("<i8"),
}
_MAX_NDIM = 32  # sanity bound; mxnet's own TShape caps far below this


class _Cursor:
    """Bounded little-endian reader; every read is overrun-checked."""

    def __init__(self, data: bytes, label: str):
        self._d = data
        self._n = len(data)
        self._p = 0
        self._label = label

    def take(self, nbytes: int) -> bytes:
        if nbytes < 0 or self._p + nbytes > self._n:
            raise ValueError(
                f"{self._label}: truncated file (need {nbytes} bytes at "
                f"offset {self._p}, have {self._n - self._p})")
        out = self._d[self._p:self._p + nbytes]
        self._p += nbytes
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def s32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def s64_list(self, n: int) -> tuple:
        return struct.unpack(f"<{n}q", self.take(8 * n))

    def u32_list(self, n: int) -> tuple:
        return struct.unpack(f"<{n}I", self.take(4 * n))

    def done(self) -> bool:
        return self._p == self._n


def _read_shape(cur: _Cursor, ndim: int, legacy_u32: bool) -> tuple:
    if ndim > _MAX_NDIM:
        raise ValueError(
            f"{cur._label}: implausible ndim {ndim} (corrupt header?)")
    dims = cur.u32_list(ndim) if legacy_u32 else cur.s64_list(ndim)
    if any(d < 0 for d in dims):
        raise ValueError(f"{cur._label}: negative dimension in {dims}")
    return dims


def decode_ndarray_file(data: bytes, label: str = "<params>") -> dict:
    """Decode the raw bytes of an ``mx.nd.save`` dict checkpoint into
    ``{name: np.ndarray}`` (dtype preserved).  Strict: any malformed,
    truncated, sparse, unnamed, or trailing-garbage input raises
    ``ValueError``."""
    cur = _Cursor(data, label)
    if cur.u64() != _LIST_MAGIC:
        raise ValueError(f"{label}: bad list magic (not an NDArray file)")
    cur.u64()  # reserved word (mxnet writes 0; value not specified)
    n_arrays = cur.u64()
    if n_arrays > 1_000_000:
        raise ValueError(f"{label}: implausible array count {n_arrays}")

    arrays = []
    for i in range(n_arrays):
        tag = cur.u32()
        if tag in (_BLOB_MAGIC_V2, _BLOB_MAGIC_V3):
            stype = cur.s32()
            if stype != 0:  # kDefaultStorage
                raise ValueError(
                    f"{label}: array {i} has sparse storage type {stype}")
            dims = _read_shape(cur, cur.u32(), legacy_u32=False)
        elif tag == _BLOB_MAGIC_V1:
            dims = _read_shape(cur, cur.u32(), legacy_u32=False)
        else:
            # Pre-magic legacy blob: the tag itself is the ndim of a
            # uint32 TShape.
            dims = _read_shape(cur, tag, legacy_u32=True)
        cur.s32()  # context dev_type
        cur.s32()  # context dev_id
        type_flag = cur.s32()
        if type_flag not in _TYPE_FLAGS:
            raise ValueError(
                f"{label}: array {i} has unknown type_flag {type_flag}")
        dt = _TYPE_FLAGS[type_flag]
        count = 1
        for d in dims:
            count *= d
        payload = cur.take(count * dt.itemsize)
        arrays.append(
            np.frombuffer(payload, dt, count).reshape(dims).copy())

    n_names = cur.u64()
    if n_names != n_arrays:
        # mx.nd.save of a bare list stores zero names; the checkpoint
        # consumers here all require the dict form — surface it rather
        # than returning a silently empty/partial mapping.
        raise ValueError(
            f"{label}: {n_arrays} arrays but {n_names} names "
            f"(unnamed list-form checkpoint?)")
    names = []
    for _ in range(n_names):
        names.append(cur.take(cur.u64()).decode("utf-8"))
    if not cur.done():
        raise ValueError(f"{label}: trailing bytes after name table")
    if len(set(names)) != len(names):
        raise ValueError(f"{label}: duplicate names in checkpoint")
    return dict(zip(names, arrays))


def read_params_file(path: str) -> dict:
    with open(path, "rb") as f:
        return decode_ndarray_file(f.read(), label=path)


def cross_check(path: str) -> dict:
    """Decode ``path`` with BOTH decoders and require exact agreement
    (names, shapes, float32-cast values).  Returns the primary decoder's
    mapping on success; raises ``ValueError`` on any disagreement.

    Use on real downloaded checkpoints before trusting a conversion:
    ``python -m alink_tpu_torch.tools.mxnet_ndarray_check model-0000.params``.
    """
    from alink_tpu_torch.tools.convert_mxnet import read_mxnet_ndarray_file

    primary = read_mxnet_ndarray_file(path)
    second = read_params_file(path)
    if set(primary) != set(second):
        raise ValueError(
            f"{path}: decoders disagree on names: "
            f"only-primary={sorted(set(primary) - set(second))[:5]} "
            f"only-second={sorted(set(second) - set(primary))[:5]}")
    for k in primary:
        a, b = primary[k], second[k].astype(np.float32)
        if a.shape != b.shape:
            raise ValueError(
                f"{path}: shape mismatch for {k}: {a.shape} vs {b.shape}")
        if not np.array_equal(a, b, equal_nan=True):
            raise ValueError(f"{path}: value mismatch for {k}")
    return primary


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Cross-validate an MXNet .params file against two "
                    "independent decoders")
    ap.add_argument("path")
    args = ap.parse_args(argv)
    raw = cross_check(args.path)
    print(f"OK: {len(raw)} arrays agree across both decoders")
    for k in sorted(raw)[:10]:
        print(f"  {k}: {raw[k].shape}")


if __name__ == "__main__":
    main()
