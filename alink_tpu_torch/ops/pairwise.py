"""All-pairs siamese scoring.

Counterpart of ``alink_tpu/ops/pairwise.py``.  For row features L (N, D),
column features R (M, D) and the siamese head
``|l - r| -> Dense(H1) relu -> Dense(H2) relu -> Dense(2)``, the score of
pair (i, j) is P(genuine) = sigmoid(logit_1 - logit_0).  Operands are
rounded to bf16 and products accumulate in f32, as in the JAX package.

- ``score_matrix_reference`` — plain PyTorch, blocked over rows.
- ``score_matrix_kernel``    — the hand-written kernel ``csrc/pair_score.cu``
  (replaces the TPU kernel ``alink_tpu/ops/pairwise.py:_fused_kernel``).
- ``score_matrix``           — dispatcher: the kernel for a two-hidden-layer
  head on CUDA tensors, the plain version otherwise.

The mesh-sharded grid (``score_matrix_sharded``) is not ported yet.
"""

from __future__ import annotations

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


# kDC, kMaxH1 and kMaxH2 of csrc/pair_score.cu: the D chunk that W1 is
# padded to, and the widest padded hidden layers its register and
# shared-memory accumulators hold.
_D_CHUNK = 64
_MAX_H1 = 512
_MAX_H2 = 256


@torch.no_grad()
def score_matrix_kernel(head, rows: torch.Tensor,
                        cols: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/pair_score.cu`` on CUDA tensors.

    Takes two-hidden-layer heads with H1 <= 512 and H2 <= 256 (padded to
    16); any D.  ``score_matrix_kernel.launches`` counts the launches.
    """
    if not (rows.is_cuda and cols.is_cuda):
        raise ValueError("score_matrix_kernel needs CUDA tensors")
    layers = head_weights(head)
    if len(layers) != 3:
        raise ValueError("the fused scorer takes 2 hidden layers + output")
    (w1, b1), (w2, b2), (wo, bo) = layers
    n, d = rows.shape
    m = cols.shape[0]
    if cols.shape[1] != d or w1.shape[0] != d:
        raise ValueError(f"feature widths differ: rows {d}, cols "
                         f"{cols.shape[1]}, head {w1.shape[0]}")
    h1p = -(-w1.shape[1] // 16) * 16
    h2p = -(-w2.shape[1] // 16) * 16
    if h1p > _MAX_H1 or h2p > _MAX_H2:
        raise ValueError(f"head widths ({w1.shape[1]}, {w2.shape[1]}) exceed "
                         f"the fused kernel's limit ({_MAX_H1}, {_MAX_H2}): "
                         "its hidden accumulator lives in registers and "
                         "shared memory")
    dp = -(-d // _D_CHUNK) * _D_CHUNK
    dev = rows.device
    w1p = _pad_to(w1.float(), dp, h1p).to(dev, torch.bfloat16).contiguous()
    w2p = _pad_to(w2.float(), h1p, h2p).to(dev, torch.bfloat16).contiguous()
    wop = _bf16(_pad_to(wo.float(), h2p, 2)).to(dev).contiguous()
    b1p = F.pad(b1.float(), (0, h1p - b1.shape[0])).to(dev).contiguous()
    b2p = F.pad(b2.float(), (0, h2p - b2.shape[0])).to(dev).contiguous()
    bop = bo.float().to(dev).contiguous()
    rows = rows.float().contiguous()
    cols = cols.float().to(dev).contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.alink_pair_score(
            rows.data_ptr(), cols.data_ptr(), n, m, d, dp, w1p.data_ptr(),
            b1p.data_ptr(), h1p, w2p.data_ptr(), b2p.data_ptr(), h2p,
            wop.data_ptr(), bop.data_ptr(), out.data_ptr(), stream)
    score_matrix_kernel.launches += 1
    _build.check(status, "pair_score")
    return out


score_matrix_kernel.launches = 0


def score_matrix(head, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """All-pairs P(genuine): the fused kernel for a two-hidden-layer head on
    CUDA tensors, the plain version for other heads and on the CPU."""
    if rows.is_cuda and len(head.hidden) == 2:
        return score_matrix_kernel(head, rows, cols)
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no scorer for device {rows.device}")
    return score_matrix_reference(head, rows, cols)


def _topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (lax.top_k's
    order; torch.topk does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def identification_topk(head, probes: torch.Tensor, gallery: torch.Tensor,
                        k: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery matches per probe: (scores (N, k), indices (N, k))."""
    return _topk_stable(score_matrix(head, probes, gallery), k)
