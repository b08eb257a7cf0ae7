"""Convert MXNet checkpoints (ArcFace LResNet100E-II, its genderage
sibling, MTCNN det1-4) to the port's state dicts (counterpart of
``alink_tpu/tools/convert_mxnet.py``).

The reference ships its face backbones as MXNet checkpoints
(``model-r100-ii/model-0000.params`` fetched by ``arcface_prepreq.sh:9-22``
and loaded at ``code/face_model.py:28-41``; the MTCNN ``det1..det4``
checkpoints loaded at ``code/mtcnn_detector.py:52-65``).  This module maps
those parameter sets onto ``models.ArcFaceResNet100`` / ``models.mtcnn``.
Each tree builder gives the JAX package's parameter tree (numpy, flax
names) and ``state_dict`` turns it into the port's names and layouts
(``convert.state_dict_from_flax``):

- conv weights: MXNet OIHW -> HWIO in the tree (OIHW again in the state
  dict);
- PReLU ``relu*_gamma`` -> ``_PReLU_*/alpha``;
- BatchNorm {gamma, beta, moving_mean, moving_var} -> ``_FrozenBN_*``;
- fully-connected layers after a flatten: MXNet flattens NCHW while both
  packages flatten NHWC, so the kernel's input axis is permuted
  ``(c, h, w) -> (h, w, c)`` using the known pre-flatten feature shape;
- the fc1 output BatchNorm folds into the model's affine
  ``fc1_gamma/fc1_beta`` (gamma' = g/sqrt(v+eps), beta' = b - m*gamma',
  eps 2e-5).

Input formats: a ``.npz`` (e.g. produced by
``numpy.savez(path, **{k: v.asnumpy() for k, v in mx.nd.load(p).items()})``
on any machine with mxnet), or the binary ``.params`` NDArray-list format
itself (``read_mxnet_ndarray_file``, V1/V2/V3 + pre-magic legacy blobs,
dense storage); keys may carry MXNet's ``arg:``/``aux:`` prefixes.

CLI (writes the state dict with ``train.checkpoint.save``, a directory)::

    python -m alink_tpu_torch.tools.convert_mxnet arcface model.params out
    python -m alink_tpu_torch.tools.convert_mxnet genderage gamodel.params out
    python -m alink_tpu_torch.tools.convert_mxnet pnet det1.npz out
"""

from __future__ import annotations

import argparse
import re
import struct

import numpy as np
import torch

from alink_tpu_torch.convert import state_dict_from_flax

_BN_EPS = 2e-5  # MXNet/insightface BatchNorm default (symbol json eps)


# --------------------------------------------------------------------------
# raw parameter loading
# --------------------------------------------------------------------------

def _strip_prefix(name: str) -> str:
    for p in ("arg:", "aux:"):
        if name.startswith(p):
            return name[len(p):]
    return name


def load_raw(path: str) -> dict:
    """Load {name: ndarray} from .npz or (best-effort) MXNet .params."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {_strip_prefix(k): np.asarray(z[k]) for k in z.files}
    return {_strip_prefix(k): v for k, v in
            read_mxnet_ndarray_file(path).items()}


_NDARRAY_V1_MAGIC = 0xF993FAC8  # int64 TShape, no storage type
_NDARRAY_V2_MAGIC = 0xF993FAC9  # + int32 storage type (mxnet >= 1.0)
_NDARRAY_V3_MAGIC = 0xF993FACA  # numpy-shape semantics (mxnet 2.x)
_DEFAULT_STORAGE = 0            # NDArrayStorageType::kDefaultStorage


def read_mxnet_ndarray_file(path: str) -> dict:
    """Reader for ``mx.nd.save`` files (dense arrays).

    Layout (mxnet ``src/c_api/c_api.cc`` MXNDArraySave +
    ``src/ndarray/ndarray.cc`` NDArray::Save/Load): uint64 list magic
    0x112, uint64 reserved, uint64 count, count NDArray blobs, uint64
    name count, names as (uint64 len, bytes).  Each blob leads with a
    uint32 magic:

    - V2 (0xF993FAC9, every mxnet 1.x checkpoint incl. the reference's
      ``model-r100-ii`` and ``det1..det4``) and V3 (0xF993FACA): int32
      storage type (dense = kDefaultStorage = 0), shape as uint32 ndim +
      int64 dims, int32 dev_type, int32 dev_id, int32 type_flag, data.
    - V1 (0xF993FAC8): same but without the storage-type field.
    - Anything else is a pre-magic legacy blob whose leading uint32 IS
      the ndim of a uint32 TShape.

    Only dense payloads are handled — convert sparse checkpoints to
    ``.npz`` with mxnet elsewhere.  ``tools.mxnet_ndarray_check`` decodes
    the same files independently.
    """
    with open(path, "rb") as f:
        buf = f.read()
    off = 0

    def u64():
        nonlocal off
        (v,) = struct.unpack_from("<Q", buf, off)
        off += 8
        return v

    def i32():
        nonlocal off
        (v,) = struct.unpack_from("<i", buf, off)
        off += 4
        return v

    if u64() != 0x112:
        raise ValueError(f"{path}: not an MXNet NDArray list file")
    u64()  # reserved
    count = u64()
    dtypes = {0: np.float32, 1: np.float64, 2: np.float16,
              3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
    arrays = []
    for _ in range(count):
        (magic,) = struct.unpack_from("<I", buf, off)
        if magic in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
            off += 4
            stype = i32()
            if stype != _DEFAULT_STORAGE:
                raise ValueError(
                    f"{path}: sparse NDArray (stype={stype}) not supported")
            (ndim,) = struct.unpack_from("<I", buf, off)
            off += 4
            dims = struct.unpack_from(f"<{ndim}q", buf, off)
            off += 8 * ndim
        elif magic == _NDARRAY_V1_MAGIC:
            off += 4
            (ndim,) = struct.unpack_from("<I", buf, off)
            off += 4
            dims = struct.unpack_from(f"<{ndim}q", buf, off)
            off += 8 * ndim
        else:
            # Legacy: the leading uint32 is the ndim of a uint32 TShape.
            (ndim,) = struct.unpack_from("<I", buf, off)
            off += 4
            dims = struct.unpack_from(f"<{ndim}I", buf, off)
            off += 4 * ndim
        i32()  # dev_type
        i32()  # dev_id
        type_flag = i32()
        dt = np.dtype(dtypes[type_flag])
        n = int(np.prod(dims)) if ndim else 1
        arr = np.frombuffer(buf, dt, n, off).reshape(dims)
        off += n * dt.itemsize
        arrays.append(arr.astype(np.float32))
    n_names = u64()
    if n_names != count:
        # mx.nd.save of a bare list stores zero names; zip() would then
        # silently drop every array.  All checkpoint consumers here need
        # the dict form (face_model.py:34 loads arg/aux dicts) — raise.
        raise ValueError(
            f"{path}: {count} arrays but {n_names} names "
            f"(unnamed list-form checkpoint?)")
    names = []
    for _ in range(n_names):
        ln = u64()
        names.append(buf[off:off + ln].decode())
        off += ln
    return dict(zip(names, arrays))


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def _conv(raw: dict, name: str) -> dict:
    out = {"kernel": np.transpose(raw[f"{name}_weight"], (2, 3, 1, 0))}
    if f"{name}_bias" in raw:
        out["bias"] = np.asarray(raw[f"{name}_bias"])
    return out


def _bn(raw: dict, name: str) -> dict:
    return {
        "gamma": np.asarray(raw[f"{name}_gamma"]),
        "beta": np.asarray(raw[f"{name}_beta"]),
        "mean": np.asarray(raw[f"{name}_moving_mean"]),
        "var": np.asarray(raw[f"{name}_moving_var"]),
    }


def _prelu(raw: dict, name: str) -> dict:
    return {"alpha": np.asarray(raw[f"{name}_gamma"]).reshape(-1)}


def _dense_from_nchw(raw: dict, name: str, chw: tuple[int, int, int]) -> dict:
    """MXNet FC over an NCHW flatten -> flax Dense over an NHWC flatten."""
    w = np.asarray(raw[f"{name}_weight"])       # (out, C*H*W)
    c, h, wd = chw
    w = w.reshape(w.shape[0], c, h, wd).transpose(2, 3, 1, 0)
    out = {"kernel": w.reshape(h * wd * c, -1)}
    if f"{name}_bias" in raw:
        out["bias"] = np.asarray(raw[f"{name}_bias"])
    return out


def _dense(raw: dict, name: str) -> dict:
    out = {"kernel": np.asarray(raw[f"{name}_weight"]).T}
    if f"{name}_bias" in raw:
        out["bias"] = np.asarray(raw[f"{name}_bias"])
    return out


def _first(raw: dict, *candidates: str) -> str:
    for c in candidates:
        if f"{c}_weight" in raw or f"{c}_gamma" in raw:
            return c
    raise KeyError(f"none of {candidates} present "
                   f"(have e.g. {sorted(raw)[:8]} ...)")


# --------------------------------------------------------------------------
# ArcFace LResNet100E-II
# --------------------------------------------------------------------------

def infer_stage_sizes(raw: dict) -> tuple[int, ...]:
    """Count ``stage{s}_unit{u}`` blocks present in a raw checkpoint.

    Lets one converter cover the whole LResNet zoo the reference's loader
    accepts (face_model.py:28-41): r34 (3, 4, 6, 3), r50 (3, 4, 14, 3),
    r100 (3, 13, 30, 3) — the depth is read off the file, not guessed.
    Stages/units are 1-based and contiguous in MXNet naming.  A gap
    (e.g. stage2 has units 1-4 and 6-13 but no unit5: a pruned or
    partially-written file) must NOT silently infer a shallower model —
    every ``stage{s}_unit{u}`` key present in the file is checked
    against the counted contiguous prefix and any orphan raises.
    """
    sizes = []
    for s in range(1, 99):
        u = 0
        while f"stage{s}_unit{u + 1}_bn1_gamma" in raw:
            u += 1
        if u == 0:
            break
        sizes.append(u)
    if not sizes:
        raise KeyError("no stage{s}_unit{u} parameters found — not an "
                       "LResNet checkpoint")
    pat = re.compile(r"stage(\d+)_unit(\d+)_")
    for key in raw:
        m = pat.match(key)
        if m:
            s, u = int(m.group(1)), int(m.group(2))
            if s < 1 or s > len(sizes) or u < 1 or u > sizes[s - 1]:
                raise KeyError(
                    f"checkpoint has {key!r} outside the contiguous "
                    f"stage/unit grid {tuple(sizes)} — truncated or "
                    "non-LResNet file; pass stage_sizes explicitly if "
                    "this layout is intentional")
    return tuple(sizes)


def arcface_param_tree(
    raw: dict,
    stage_sizes: tuple[int, ...] | None = None,
) -> dict:
    """Map insightface LResNet params onto ``models.ArcFaceResNet100``.

    MXNet naming (model-r100-ii): stem ``conv0/bn0/relu0``; unit u of
    stage s: ``stage{s}_unit{u}_{bn1,conv1,bn2,relu1,conv2,bn3}`` plus
    ``_conv1sc``/``_sc`` (shortcut conv + BN) on the stride-2 entry unit;
    tail ``bn1``, ``pre_fc1``, ``fc1`` (output BN).  ``stage_sizes=None``
    infers the depth from the checkpoint (r34/r50/r100 all convert).
    """
    if stage_sizes is None:
        stage_sizes = infer_stage_sizes(raw)
    p: dict = {
        "Conv_0": _conv(raw, "conv0"),
        "_FrozenBN_0": _bn(raw, "bn0"),
        "_PReLU_0": _prelu(raw, "relu0"),
    }
    k = 0
    for s, blocks in enumerate(stage_sizes, start=1):
        for u in range(1, blocks + 1):
            base = f"stage{s}_unit{u}"
            unit = {
                "_FrozenBN_0": _bn(raw, f"{base}_bn1"),
                "Conv_0": _conv(raw, f"{base}_conv1"),
                "_FrozenBN_1": _bn(raw, f"{base}_bn2"),
                "_PReLU_0": _prelu(raw, f"{base}_relu1"),
                "Conv_1": _conv(raw, f"{base}_conv2"),
                "_FrozenBN_2": _bn(raw, f"{base}_bn3"),
            }
            if f"{base}_conv1sc_weight" in raw:  # projection shortcut
                unit["Conv_2"] = _conv(raw, f"{base}_conv1sc")
                unit["_FrozenBN_3"] = _bn(raw, f"{base}_sc")
            p[f"_IRUnit_{k}"] = unit
            k += 1
    p["_FrozenBN_1"] = _bn(raw, "bn1")
    # Output head: the "E" layout is BN(bn1) - flatten - FC - [BN(fc1)].
    # Recognition checkpoints (model-r100-ii etc.) name the FC ``pre_fc1``
    # and follow it with the ``fc1`` BatchNorm; the genderage checkpoint
    # (gamodel, loaded by the SAME reference get_model at
    # face_model.py:52-54) runs the identical trunk to a 202-d fc1 —
    # accept either a ``pre_fc1`` FC or a bare ``fc1`` FullyConnected,
    # and make the output BN fold identity when the file has none.
    c = raw["bn1_gamma"].shape[0]
    fc = "pre_fc1" if "pre_fc1_weight" in raw else "fc1"
    if raw[f"{fc}_weight"].ndim != 2:
        raise KeyError(f"{fc}_weight is not a FullyConnected weight")
    hw = int(round((raw[f"{fc}_weight"].shape[1] / c) ** 0.5))
    p["Dense_0"] = _dense_from_nchw(raw, fc, (c, hw, hw))
    dim = raw[f"{fc}_weight"].shape[0]
    if fc == "pre_fc1" and "fc1_gamma" in raw:
        # fc1 output BatchNorm folds into the model's affine gamma/beta.
        g, b = raw["fc1_gamma"], raw["fc1_beta"]
        m, v = raw["fc1_moving_mean"], raw["fc1_moving_var"]
        scale = g / np.sqrt(v + _BN_EPS)
        p["fc1_gamma"] = np.asarray(scale, np.float32)
        p["fc1_beta"] = np.asarray(b - m * scale, np.float32)
    else:
        p["fc1_gamma"] = np.ones((dim,), np.float32)
        p["fc1_beta"] = np.zeros((dim,), np.float32)
    return {"params": p}


# --------------------------------------------------------------------------
# MTCNN det1-4
# --------------------------------------------------------------------------

def pnet_param_tree(raw: dict) -> dict:
    """det1: conv1-3 + PReLU, conv4_1 (cls 2ch) / conv4_2 (reg 4ch)."""
    return {"params": {
        "Conv_0": _conv(raw, "conv1"),
        "_PReLU_0": _prelu(raw, _first(raw, "prelu1", "PReLU1")),
        "Conv_1": _conv(raw, "conv2"),
        "_PReLU_1": _prelu(raw, _first(raw, "prelu2", "PReLU2")),
        "Conv_2": _conv(raw, "conv3"),
        "_PReLU_2": _prelu(raw, _first(raw, "prelu3", "PReLU3")),
        "Conv_3": _conv(raw, "conv4_1"),
        "Conv_4": _conv(raw, "conv4_2"),
    }}


def _rnet_like_tree(raw: dict, chw: tuple[int, int, int],
                    fc: str, heads: list[tuple[str, str]]) -> dict:
    p = {
        "Conv_0": _conv(raw, "conv1"),
        "_PReLU_0": _prelu(raw, _first(raw, "prelu1", "PReLU1")),
        "Conv_1": _conv(raw, "conv2"),
        "_PReLU_1": _prelu(raw, _first(raw, "prelu2", "PReLU2")),
        "Conv_2": _conv(raw, "conv3"),
        "_PReLU_2": _prelu(raw, _first(raw, "prelu3", "PReLU3")),
    }
    n_convs = 3
    if "conv4_weight" in raw and raw["conv4_weight"].ndim == 4:
        p["Conv_3"] = _conv(raw, "conv4")
        p["_PReLU_3"] = _prelu(raw, _first(raw, "prelu4", "PReLU4"))
        n_convs = 4
    p["Dense_0"] = _dense_from_nchw(raw, fc, chw)
    p[f"_PReLU_{n_convs}"] = _prelu(
        raw, _first(raw, f"prelu{n_convs + 1}", f"PReLU{n_convs + 1}"))
    for i, (ours, theirs) in enumerate(heads):
        p[ours] = _dense(raw, theirs)
    return {"params": p}


def rnet_param_tree(raw: dict) -> dict:
    """det2: conv1-3, fc conv4 (64x3x3 -> 128), heads conv5_1/conv5_2."""
    return _rnet_like_tree(raw, (64, 3, 3), "conv4",
                           [("Dense_1", "conv5_1"), ("Dense_2", "conv5_2")])


def onet_param_tree(raw: dict) -> dict:
    """det3: conv1-4, fc conv5 (128x3x3 -> 256), heads conv6_1/2/3."""
    return _rnet_like_tree(raw, (128, 3, 3), "conv5",
                           [("Dense_1", "conv6_1"), ("Dense_2", "conv6_2"),
                            ("Dense_3", "conv6_3")])


def lnet_param_tree(raw: dict) -> dict:
    """det4: RNet-shaped tower on 15-channel patch stacks, with FIVE
    per-landmark (dx, dy) heads — the reference consumes a 5-list of
    (N, 2) outputs (mtcnn_detector.py:498-508), and ``models.LNet``
    declares ``Dense_1..Dense_5`` accordingly."""
    heads = [(f"Dense_{i}", _first(raw, f"conv5_{i}", f"fc5_{i}"))
             for i in range(1, 6)]
    return _rnet_like_tree(raw, (64, 3, 3), "conv4", heads)


def genderage_param_tree(raw: dict,
                         stage_sizes: tuple[int, ...] | None = None) -> dict:
    """Map the genderage checkpoint (face_model.py:95-107) onto
    ``ArcFaceResNet100(embedding_dim=202, normalize=False)``.

    The gamodel is the same LResNet trunk the recognition checkpoints
    use, ending in a 202-d fc1 (gender 2 + age 100x2; see
    ``models.genderage.decode_ga``), so the mapping is the arcface one —
    the function exists so the CLI names the capability and so the
    202-d output width is verified rather than assumed.
    """
    tree = arcface_param_tree(raw, stage_sizes=stage_sizes)
    dim = tree["params"]["fc1_gamma"].shape[0]
    if dim != 202:
        raise ValueError(
            f"genderage checkpoints end in a 202-d fc1, got {dim} — "
            "use the 'arcface' converter for recognition checkpoints")
    return tree


_CONVERTERS = {
    "arcface": arcface_param_tree,
    "genderage": genderage_param_tree,
    "pnet": pnet_param_tree,
    "rnet": rnet_param_tree,
    "onet": onet_param_tree,
    "lnet": lnet_param_tree,
}


def state_dict(model: str, raw: dict,
               stage_sizes: tuple[int, ...] | None = None
               ) -> dict[str, torch.Tensor]:
    """The port's state dict of ``model`` (a key of the converters:
    arcface, genderage, pnet, rnet, onet, lnet) from a raw checkpoint;
    ``stage_sizes`` overrides the LResNet depth inference."""
    if stage_sizes is not None:
        if model not in ("arcface", "genderage"):
            raise ValueError("stage_sizes only applies to the LResNet "
                             "converters")
        return state_dict_from_flax(_CONVERTERS[model](raw, stage_sizes))
    return state_dict_from_flax(_CONVERTERS[model](raw))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model", choices=sorted(_CONVERTERS))
    ap.add_argument("src", help=".npz or MXNet .params file")
    ap.add_argument("out", help="output directory (train.checkpoint.save)")
    ap.add_argument("--stage_sizes", default=None,
                    help="arcface only: comma-separated unit counts "
                         "(e.g. 3,13,30,3) to override depth inference "
                         "for non-standard checkpoints")
    args = ap.parse_args(argv)
    sizes = None
    if args.stage_sizes is not None:
        if args.model not in ("arcface", "genderage"):
            ap.error("--stage_sizes only applies to the LResNet converters")
        sizes = tuple(int(s) for s in args.stage_sizes.split(","))
    state = state_dict(args.model, load_raw(args.src), sizes)
    from alink_tpu_torch.train.checkpoint import save

    save(args.out, state)
    print(f"wrote {args.model} state dict -> {args.out}")


if __name__ == "__main__":
    main()
