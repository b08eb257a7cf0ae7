"""All-pairs siamese scoring.

Counterpart of ``alink_tpu/ops/pairwise.py``.  For row features L (N, D),
column features R (M, D) and the siamese head
``|l - r| -> Dense(H1) relu -> Dense(H2) relu -> Dense(2)``, the score of
pair (i, j) is P(genuine) = sigmoid(logit_1 - logit_0).  Operands are
rounded to bf16 and products accumulate in f32, as in the JAX package.

- ``score_matrix_reference`` — plain PyTorch, blocked over rows.
- ``score_matrix_kernel``    — the hand-written kernel ``csrc/pair_score.cu``
  (replaces the TPU kernel ``alink_tpu/ops/pairwise.py:_fused_kernel``),
  on the head's weights packed once (``pack_head``, cached on the head by
  ``packed_head``) with a launch decided here (``launch_plan``).
- ``score_matrix``           — dispatcher: the kernel for every
  two-hidden-layer head on CUDA tensors (any H1 and D; an H2 over 256 runs
  as chunks of 256 columns, ``head_chunks``), the plain version for other
  heads and on the CPU.
- ``score_matrix_sharded``   — the grid over a (data, model) mesh: rows
  over ``data``, columns over ``model``, each rank's tile through
  ``score_matrix``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from alink_tpu_torch import _build


def head_weights(head) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """((W (in, out), b), ...) of a ``SiameseHead`` in application order:
    hidden_0, hidden_1, ..., out.  A sigmoid head's single output column
    is prefixed with a zero column (the ``[0, logit]`` convention)."""
    layers = [(lin.weight.t(), lin.bias) for lin in head.hidden]
    wo, bo = head.out.weight.t(), head.out.bias
    if wo.shape[-1] == 1:
        wo = torch.cat([torch.zeros_like(wo), wo], dim=-1)
        bo = torch.cat([torch.zeros_like(bo), bo], dim=-1)
    return tuple(layers) + ((wo, bo),)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and hold in f32: bf16 operands, f32 accumulation."""
    return x.to(torch.bfloat16).float()


def _apply_head(x: torch.Tensor, layers) -> torch.Tensor:
    """MLP over |l - r| rows (…, D) -> P(genuine) (…)."""
    for w, b in layers[:-1]:
        x = torch.relu(_bf16(x) @ _bf16(w.float()) + b.float())
    wo, bo = layers[-1]
    logits = _bf16(x) @ _bf16(wo.float()) + bo.float()
    return torch.sigmoid(logits[..., 1] - logits[..., 0])


def pair_scores(head, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """P(genuine) for aligned feature pairs (N, D) x (N, D) -> (N,);
    differentiable in the features when grad is enabled (the FGSM channel's
    predict function), with the bf16 roundings passing gradients through.
    The head's parameters enter as constants."""
    layers = tuple((w.detach(), b.detach()) for w, b in head_weights(head))
    return _apply_head(torch.abs(left.float() - right.float()), layers)


# Row blocks of the plain scorer bound its (rows, M, D) |l - r| tile.
_MAX_TILE_ELEMS = 1 << 24


@torch.no_grad()
def score_matrix_reference(head, rows: torch.Tensor,
                           cols: torch.Tensor) -> torch.Tensor:
    """Plain all-pairs scorer: (N, D) x (M, D) -> (N, M) P(genuine)."""
    layers = head_weights(head)
    n, m = rows.shape[0], cols.shape[0]
    rows, cols = rows.float(), cols.float()
    rb = max(1, _MAX_TILE_ELEMS // max(1, m * rows.shape[1]))
    out = [_apply_head(torch.abs(rows[i:i + rb, None, :] - cols[None]), layers)
           for i in range(0, n, rb)]
    return torch.cat(out) if out else rows.new_zeros((0, m))


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


# Tiling of csrc/pair_score.cu.  A tile is 8 rows x 16 columns of pairs
# (128: one m64 product per consumer warpgroup); D runs in slabs of 64
# (4 k16 products), H1 in passes of ``np1`` columns, H2 padded to ``h2p``.
# Within each 16-deep product, column kk of the kernel's A operand holds
# feature _K_PERM[kk] of the slice: thread t of a quad reads features
# 4t..4t+3 in one 16-byte load, which the mma fragment layout places at
# columns 2t, 2t+1, 2t+8, 2t+9.  W1's rows are packed in that order.
_TI, _TJ, _KS = 8, 16, 64
_K_PERM = [4 * ((kk & 7) >> 1) + 2 * (kk >> 3) + (kk & 1) for kk in range(16)]
_H2_WIDTHS = (32, 64, 128, 256)
_FEAT_BYTES = (_TI + _TJ) * _KS * 4     # one slab of both feature tiles
_MAX_STAGES = 8
_MAX_SMEM = 232448
_SCORE_BYTES = _TI * _TJ * 4
_BAR_BYTES = 2 * 8 * _MAX_STAGES
_GROUP = 8                              # row tiles per band of the walk
_SMS = 132                              # streaming multiprocessors, H100 SXM


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def head_tiling(h1: int, h2: int) -> tuple[int, int, int]:
    """(np1, h2p, h1p): the H1 pass width, the padded H2 and the padded H1
    one launch of the kernel runs at (a head, or one chunk of a head wider
    than 256 in H2, ``head_chunks``).  A consumer warpgroup holds np1 / 2 +
    h2p / 2 f32 accumulators a thread (at most 160): passes of 256 columns
    where H2 pads to 64 or less, 128 at 128, 64 at 256."""
    if not 0 < h2 <= _H2_WIDTHS[-1] or h1 <= 0:
        raise ValueError(f"one launch of the fused scorer takes 0 < H2 <= "
                         f"{_H2_WIDTHS[-1]} (wider heads run in chunks, "
                         f"head_chunks); got head widths ({h1}, {h2})")
    h2p = next(c for c in _H2_WIDTHS if c >= h2)
    np1 = 64 if h2p == 256 else 128 if (h2p == 128 or h1 <= 128) else 256
    return np1, h2p, _rup(h1, np1)


def head_chunks(h2: int) -> tuple[tuple[int, int], ...]:
    """The H2 column ranges [c0, c1) a head runs as, one launch each: the
    whole head up to 256, else chunks of 256 and the rest.  The output layer
    is linear after the relu, so the logit difference is the sum of the
    chunks' (the output bias in the first only)."""
    if h2 <= 0:
        raise ValueError(f"H2 must be positive, got {h2}")
    w = _H2_WIDTHS[-1]
    return tuple((c, min(c + w, h2)) for c in range(0, h2, w))


def chunk_mode(k: int, chunks: int) -> int:
    """The kernel's ``mode`` for launch k of ``chunks``: 0 a whole head; 1
    the first chunk (stores its logit difference), 2 a middle one (adds its
    own), 3 the last (adds, then the sigmoid)."""
    if chunks == 1:
        return 0
    return 1 if k == 0 else 3 if k == chunks - 1 else 2


class HeadPacked(NamedTuple):
    """A two-hidden-layer head in the order ``csrc/pair_score.cu`` stages
    it (``pack_head``), zero-padded: for each H1 pass and D slab, W1's 4
    k16 slices as wgmma's K-major core matrices (8 columns x 8 rows of K,
    16 bytes a column), rows in ``_K_PERM`` order; for each pass, W2's rows
    of that pass the same way; biases f32, the output layer f32 rounded to
    bf16 (its products run on the CUDA cores).

    w1: (passes, D / 64, 4, np1 / 8, 2, 8, 8) bf16    b1: (h1p,) f32
    w2: (passes, np1 / 16, h2p / 8, 2, 8, 8) bf16     b2: (h2p,) f32
    wo: (h2p, 2) f32                                   bo: (2,) f32
    """

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    d: int
    h1: int
    h2: int
    np1: int
    h2p: int


@torch.no_grad()
def pack_head(head, device=None, cols: tuple[int, int] | None = None
              ) -> HeadPacked:
    """The weights of a two-hidden-layer ``SiameseHead`` in the kernel's
    layout (``HeadPacked``) on ``device``: with ``cols`` = (c0, c1), only
    H2 columns c0..c1 (at most 256; ``head_chunks``), the output bias kept
    in the first chunk only."""
    layers = head_weights(head)
    if len(layers) != 3:
        raise ValueError("the fused scorer takes 2 hidden layers + output")
    (w1, b1), (w2, b2), (wo, bo) = ((w.detach().float(), b.detach().float())
                                    for w, b in layers)
    if cols is not None:
        c0, c1 = cols
        w2, b2, wo = w2[:, c0:c1], b2[c0:c1], wo[c0:c1]
        bo = bo if c0 == 0 else torch.zeros_like(bo)
    d, h1 = w1.shape
    h2 = w2.shape[1]
    np1, h2p, h1p = head_tiling(h1, h2)
    dp, passes = _rup(d, _KS), h1p // np1
    t = _pad_to(w1, dp, h1p).reshape(dp // 16, 16, h1p)[:, _K_PERM]
    t = t.reshape(dp // _KS, 4, 2, 8, passes, np1 // 8, 8)
    w1p = t.permute(4, 0, 1, 5, 2, 6, 3)
    t = _pad_to(w2, h1p, h2p).reshape(passes, np1 // 16, 2, 8, h2p // 8, 8)
    w2p = t.permute(0, 1, 4, 2, 5, 3)
    return HeadPacked(
        w1p.to(device, torch.bfloat16).contiguous(),
        F.pad(b1, (0, h1p - h1)).to(device).contiguous(),
        w2p.to(device, torch.bfloat16).contiguous(),
        F.pad(b2, (0, h2p - h2)).to(device).contiguous(),
        _bf16(_pad_to(wo, h2p, 2)).to(device).contiguous(),
        bo.to(device).contiguous(), d, h1, h2, np1, h2p)


def unpack_head(p) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """``pack_head``'s inverse: ((W1, b1), (W2, b2), (Wo, bo)) f32 at the
    head's widths (the matrices as the kernel reads them, bf16-rounded).
    Takes one ``HeadPacked`` or the chunks of a head (``packed_head``),
    whose H2 columns it joins and whose output biases it sums."""
    if not isinstance(p, HeadPacked):
        parts = [unpack_head(c) for c in p]
        (w1, b1), _, (_, bo) = parts[0]
        return ((w1, b1),
                (torch.cat([q[1][0] for q in parts], 1),
                 torch.cat([q[1][1] for q in parts])),
                (torch.cat([q[2][0] for q in parts]),
                 sum(q[2][1] for q in parts[1:]) + bo))
    passes, nslab = p.w1.shape[:2]
    h1p, dp = passes * p.np1, nslab * _KS
    t = p.w1.float().permute(1, 2, 4, 6, 0, 3, 5).reshape(dp // 16, 16, h1p)
    w1 = torch.empty_like(t)
    w1[:, _K_PERM] = t
    w2 = p.w2.float().permute(0, 1, 3, 5, 2, 4).reshape(h1p, p.h2p)
    return ((w1.reshape(dp, h1p)[:p.d, :p.h1], p.b1[:p.h1]),
            (w2[:p.h1, :p.h2], p.b2[:p.h2]), (p.wo[:p.h2], p.bo))


def packed_head(head, device) -> tuple[HeadPacked, ...]:
    """The head packed for the kernel on ``device``, one ``HeadPacked`` per
    H2 chunk (``head_chunks``; one for a head up to 256 wide), cached on
    the head.  The head is trained in place (an optimizer step,
    ``load_state_dict``), so the cache is keyed on each parameter's
    identity and in-place version counter; moving the module
    (``SiameseHead._apply``) drops it."""
    device = torch.device(device)
    params = [p for lin in (*head.hidden, head.out)
              for p in (lin.weight, lin.bias)]
    key = [(p, p._version) for p in params]
    cached = getattr(head, "_packed", None)
    if (cached is None or cached[0] != device or len(cached[1]) != len(key)
            or any(a is not b or va != vb
                   for (a, va), (b, vb) in zip(cached[1], key))):
        h2 = head.hidden[-1].weight.shape[0]
        cached = (device, key, tuple(pack_head(head, device, c)
                                     for c in head_chunks(h2)))
        head._packed = cached
    return cached[2]


class PairPlan(NamedTuple):
    """How ``csrc/pair_score.cu`` runs one launch (``launch_plan``)."""

    np1: int                # H1 pass width (the layer-1 product's N)
    h2p: int                # padded H2 (the layer-2 product's N)
    h1p: int
    passes: int
    dp: int                 # D padded to the 64-deep slab
    nslab: int
    tiles_i: int            # 8-row tiles
    tiles_j: int            # 16-column tiles
    tiles: int
    group: int              # row tiles per band of the walk (L2 reuse)
    grid: int               # persistent blocks; block b walks b, b + grid, ...
    stages: int             # ring entries
    stage_bytes: int
    smem: int               # dynamic shared memory per block (bytes)


def stash_bytes(np1: int, h2p: int) -> int:
    """Shared memory that holds the layer-2 accumulator between 256-wide
    passes (f32, one slot per consumer thread and register), so that it
    leaves the registers to layer 1 there."""
    return 256 * (h2p // 2) * 4 if np1 == 256 else 0


def stage_bytes(np1: int, h2p: int) -> int:
    """One ring entry: a D slab of both feature tiles and of W1's pass, or
    one pass of W2, on a 1024-byte boundary (the features' 128-byte
    swizzle)."""
    return _rup(max(_FEAT_BYTES + np1 * _KS * 2, np1 * h2p * 2), 1024)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, m: int, d: int, h1: int, h2: int,
                sms: int = _SMS) -> PairPlan:
    """The kernel's tiling, ring and grid for an (n, d) x (m, d) grid under
    a head of widths (h1, h2), on a card of ``sms`` SMs."""
    np1, h2p, h1p = head_tiling(h1, h2)
    dp = _rup(max(d, 1), _KS)
    ti, tj = -(-n // _TI), -(-m // _TJ)
    sb = stage_bytes(np1, h2p)
    fixed = _SCORE_BYTES + _BAR_BYTES + stash_bytes(np1, h2p)
    stages = min(_MAX_STAGES, (_MAX_SMEM - fixed) // sb)
    return PairPlan(np1, h2p, h1p, h1p // np1, dp, dp // _KS, ti, tj, ti * tj,
                    _GROUP, max(1, min(ti * tj, sms)), stages, sb,
                    stages * sb + fixed)


def tile_coords(plan: PairPlan, t: int) -> tuple[int, int]:
    """(row tile, column tile) of walk position t: bands of ``group`` row
    tiles, column by column within a band, so the blocks in flight share
    a few row and column feature tiles (the kernel's ``tile_coords``)."""
    per_band = plan.group * plan.tiles_j
    band = t // per_band
    rows = min(plan.group, plan.tiles_i - band * plan.group)
    local = t - band * per_band
    return band * plan.group + local % rows, local // rows


@torch.no_grad()
def score_matrix_kernel(head, rows: torch.Tensor,
                        cols: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/pair_score.cu`` on CUDA tensors.

    Takes every two-hidden-layer head, any H1, H2 and D: a head up to 256
    wide in H2 is one launch, a wider one a launch per chunk of 256
    (``head_chunks``; the chunks' logit differences sum in the output).
    The head's weights are packed once and cached on it (``packed_head``).
    """
    if not (rows.is_cuda and cols.is_cuda):
        raise ValueError("score_matrix_kernel needs CUDA tensors")
    n, d = rows.shape
    m = cols.shape[0]
    dev = rows.device
    chunks = packed_head(head, dev)
    if cols.shape[1] != d or chunks[0].d != d:
        raise ValueError(f"feature widths differ: rows {d}, cols "
                         f"{cols.shape[1]}, head {chunks[0].d}")
    # The kernel reads the features by TMA: f32 rows of 16-byte multiples.
    d4 = _rup(d, 4)
    rows, cols = (t if t.dtype == torch.float32 and t.is_contiguous()
                  and d4 == d and t.data_ptr() % 16 == 0 else
                  F.pad(t.to(dev, torch.float32), (0, d4 - d)).contiguous()
                  for t in (rows, cols))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    for k, pk in enumerate(chunks):
        plan = launch_plan(n, m, d4, pk.h1, pk.h2, sms)
        _build.launch(
            "alink_pair_score", dev, rows.data_ptr(), cols.data_ptr(), n, m,
            d4, pk.w1.data_ptr(), pk.b1.data_ptr(), plan.h1p,
            pk.w2.data_ptr(), pk.b2.data_ptr(), plan.h2p, pk.wo.data_ptr(),
            pk.bo.data_ptr(), out.data_ptr(), plan.np1, plan.stages,
            plan.grid, plan.group, chunk_mode(k, len(chunks)))
    return out


def score_matrix(head, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """All-pairs P(genuine): the fused kernel for every two-hidden-layer
    head on CUDA tensors (any widths), the plain version for other heads
    and on the CPU."""
    if rows.is_cuda and len(head.hidden) == 2:
        return score_matrix_kernel(head, rows, cols)
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no scorer for device {rows.device}")
    return score_matrix_reference(head, rows, cols)


# The JAX package's per-backend block sizes: TPU tiling knobs, accepted
# and ignored here (the kernel's launch plan decides its own tiles).
_TPU_BLOCK_KNOBS = frozenset({"row_block", "col_block", "d_chunk",
                              "interpret", "on_tpu"})


def score_matrix_sharded(mesh, head, rows: torch.Tensor, cols: torch.Tensor,
                         **block_kwargs) -> torch.Tensor:
    """The all-pairs grid over a (data, model) mesh.

    Rows are split over ``data`` and columns over ``model`` (each padded
    with zeros to a multiple of its axis); every rank scores its own tile
    with ``score_matrix`` (kernel K1 on CUDA tensors), with no
    communication during compute, and the tiles are gathered over both
    axes.  Every rank passes the same features and gets the full (N, M)
    grid.  The JAX package's block sizes (``row_block``, ``col_block``,
    ...) are accepted and ignored.
    """
    from alink_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                               axis_size, block, coordinate,
                                               gather_axis, pad_axis0)

    unknown = set(block_kwargs) - _TPU_BLOCK_KNOBS
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    nd, nm = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    d, m = coordinate(mesh)
    n, mc = rows.shape[0], cols.shape[0]
    tile = score_matrix(head, block(pad_axis0(rows, nd), nd, d),
                        block(pad_axis0(cols, nm), nm, m))
    grid = gather_axis(gather_axis(tile, mesh, MODEL_AXIS, dim=1), mesh,
                       DATA_AXIS)
    return grid[:n, :mc]


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (lax.top_k's
    order; torch.topk does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def identification_topk(head, probes: torch.Tensor, gallery: torch.Tensor,
                        k: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery matches per probe: (scores (N, k), indices (N, k))."""
    return _topk_stable(score_matrix(head, probes, gallery), k)
