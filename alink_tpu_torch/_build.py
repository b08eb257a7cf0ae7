"""Build and load the port's CUDA kernels.

The sources in ``alink_tpu_torch/csrc/*.cu`` have a plain C interface.  At
first use each is compiled by its own ``nvcc`` for ``sm_90a``, all at once,
and the objects are linked into one shared library under
``build/alink_tpu_torch/`` (listed in ``.gitignore``), named by a hash of the
sources and flags, and loaded with ``ctypes``.  Every pointer and the
stream cross as ``c_void_p``, every int as ``c_int``, every float as
``c_float``.  Each C entry point returns ``cudaGetLastError()`` after its
launch; ``check`` raises on a non-zero status, because a refused launch
never runs and a later synchronise would not report it.

``launch`` is the one place the ops call the library: it passes the
device's current stream, raises through ``check``, and counts each
launch that succeeded under the entry's counter in ``_SIGNATURES``
(``launch_counts``, read by ``utils.profiling.counters``).

Host libraries (C++ with no CUDA, such as the JAX package's batched image
decoder ``native/loader.cc``) are built the same way by ``build_host``, with
``g++`` instead of ``nvcc``, into the same directory.

Nothing here runs at import: ``nvcc`` is looked up and the library built
only when a kernel is first launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "alink_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Each C entry point: its launch counter and its argument types (the
# stream last).
_SIGNATURES = {
    # img, dtype (0 f32, 1 uint8, 2 bf16), M (forward affines), out, n, h,
    # w, c, oh, ow,
    # border_nearest, interp_nearest, stream
    "alink_affine_warp": ("launches.k2", [_P, _I, _P, _P] + [_I] * 8 + [_P]),
    # x, n, h, w, cin, cm, cout, w1, s1, b1, w3, s2, b2, w2, s3, b3, wp, sp,
    # bp, out, act (global y1/y2 scratch or null), slots, split, blocks,
    # tile rows, tile columns, stream
    "alink_bottleneck": ("launches.k3", [_P] + [_I] * 6 + [_P] * 14
                         + [_I] * 5 + [_P]),
    # rows, cols, n, m, d, w1, b1, h1p, w2, b2, h2p, wo, bo, out, np1,
    # stages, grid, group, mode, stream
    "alink_pair_score": ("launches.k1", [_P, _P, _I, _I, _I, _P, _P, _I, _P,
                                         _P, _I, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _P]),
    # x, x_rows, ldx, cin_k, wk, cout_k, scale, bias, alpha, qscale, out,
    # ldo, mode, n, h, w, wp, r, lead, stages, resident, box_rows, nbox,
    # grid_x, stream
    "alink_qconv": ("launches.k4", [_P, _I, _I, _I, _P, _I] + [_P] * 5
                    + [_I] * 13 + [_P]),
    # mode, dtype, x, r, out, rows, c, gamma, beta, mean, var, eps, gamma2,
    # beta2, mean2, var2, eps2, alpha, stream
    "alink_bn_act": ("launches.bn_act", [_I, _I, _P, _P, _P, _I, _I]
                     + [_P] * 4 + [_F] + [_P] * 4 + [_F, _P, _P]),
    # mode, dtype, g, x, dx, dr, rows, c, then as alink_bn_act
    "alink_bn_act_backward": ("launches.bn_act_backward",
                              [_I, _I, _P, _P, _P, _P, _I, _I] + [_P] * 4
                              + [_F] + [_P] * 4 + [_F, _P, _P]),
    # q, k, v, out, n, h, t, d, strides (elements) of q, k, v along n, h,
    # t, scale, grid, stream
    "alink_attention": ("launches.attn", [_P] * 4 + [_I] * 13 + [_F, _I, _P]),
    # qkv, table, out, n, s, h, window, shift, group, scale, stream
    "alink_window_attention": ("launches.wattn", [_P] * 3 + [_I] * 6
                               + [_F, _P]),
    # boxes, valid, mask scratch, keep, n, k, threshold, stream (the mask
    # and the sweep kernels, one launch counted)
    "alink_nms": ("launches.nms", [_P] * 4 + [_I, _I, _F, _P]),
    # in dtype, out dtype, x, gamma, beta, out, rows, c, eps, stream
    "alink_layer_norm": ("launches.ln", [_I, _I] + [_P] * 4 + [_I, _I, _F,
                                                                 _P]),
}
_LAUNCHES = {counter: 0 for counter, _ in _SIGNATURES.values()}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libalink_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return nvcc


def build() -> Path:
    """Compile the kernels (one ``nvcc`` per source, in parallel) and link
    them, unless a library for these sources exists.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside the library in ``build.log``.
    """
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-Wno-deprecated-gpu-targets", "-o", str(tmp),
            *(str(o) for o in objs)]
    log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True,
                             check=False)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(log))
    os.replace(tmp, path)
    return path


def build_host(name: str, sources: Sequence[Path], flags: Sequence[str],
               libs: Sequence[str] = ()) -> Path:
    """Compile host C++ ``sources`` into one shared library with ``g++``,
    unless a library for these sources and flags exists.

    The file is ``build/alink_tpu_torch/lib<name>_<hash>.so``, the hash of
    the flags, libraries and sources; it is written to a pid-tagged
    temporary file and moved into place, so processes that build at once
    never load a half-written library.  The compiler's output is kept in
    ``<name>.build.log``; a failure raises ``RuntimeError`` with it.
    """
    cmd_tail = [*flags, "-shared"]
    h = hashlib.sha256(" ".join([*cmd_tail, *libs]).encode())
    for src in sources:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    path = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"{name}: no C++ compiler (g++ not on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [cxx, *cmd_tail, "-o", str(tmp), *(str(s) for s in sources),
           *libs]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log = " ".join(cmd) + "\n" + res.stdout + res.stderr
    (BUILD_DIR / f"{name}.build.log").write_text(log)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}:\n{log}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (_, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            lib.alink_error_string.argtypes = [_I]
            lib.alink_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        msg = load().alink_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({status}: {msg})")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and, last, the
    current CUDA stream of ``device``, with ``device`` current; raise
    through ``check`` on a non-zero status, else count one launch."""
    fn = getattr(load(), entry)
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(status, entry)
    _LAUNCHES[_SIGNATURES[entry][0]] += 1


def launch_counts() -> dict[str, int]:
    """The launches made so far, by counter (every one, from 0)."""
    return dict(_LAUNCHES)
