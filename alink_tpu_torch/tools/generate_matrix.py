"""Build the all-pairs similarity matrix from saved features (counterpart
of ``alink_tpu/tools/generate_matrix.py``).

Reference: ``utilities/generateMatrixDFW.py``: loads the siamese model and
``processedData.npy`` and predicts the 7771x7771 matrix row by row
(:30-35), writing ``np.savetxt`` output.  Here the whole grid is one call
of ``ops.pairwise.score_matrix`` (kernel K1 on the card), sharded over a
mesh of every rank (``score_matrix_sharded``) when the process group has
more than one.

Score convention: entry (i, j) = P(genuine) (the 2-class softmax's class-1
probability, ALINK.py:175).  The reference script stored class-0
probabilities (generateMatrixDFW.py:33); the masks downstream are
polarity-symmetric, and the port keeps the JAX package's P(genuine).

    python -m alink_tpu_torch.tools.generate_matrix ckpt scores.npy \\
        --features processedData.npy [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from alink_tpu_torch import train as T
from alink_tpu_torch.models import SiameseHead
from alink_tpu_torch.ops.pairwise import score_matrix, score_matrix_sharded
from alink_tpu_torch.parallel import create_mesh


def restore_head_and_score(model_ckpt: str, feats, device="cuda"
                           ) -> torch.Tensor:
    """Restore a ``SiameseHead`` checkpoint (``train.save`` of its state
    dict; the default head over the features' width, whose shapes the
    checkpoint must match) and score the full feats x feats matrix on
    ``device``, sharded over every rank when the world has more than one
    (each rank passes the same features and gets the whole grid).  Shared
    by this tool, ``tools/evaluate.py`` and ``tools/eval_regression.py``.
    Returns the (N, N) f32 grid on ``device``."""
    feats = torch.as_tensor(feats, device=device).float()
    head = SiameseHead(feats.shape[1], device=device)
    head.load_state_dict(T.restore(model_ckpt, head.state_dict()))
    with torch.no_grad():
        if dist.is_initialized() and dist.get_world_size() > 1:
            mesh = create_mesh((-1,), device_type=feats.device.type)
            return score_matrix_sharded(mesh, head, feats, feats)
        return score_matrix(head, feats, feats)


def main(argv=None) -> None:
    from alink_tpu_torch.drivers.common import resolve_device

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model_ckpt", help="train.save checkpoint of the "
                        "head's state dict")
    parser.add_argument("out", help="output path (.npy, or .txt for "
                        "reference-compatible savetxt)")
    parser.add_argument("--features", default="processedData.npy")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device, "generate_matrix")
    scores = restore_head_and_score(args.model_ckpt,
                                    np.load(args.features),
                                    device).cpu().numpy()
    if args.out.endswith(".txt"):
        np.savetxt(args.out, scores)
    else:
        np.save(args.out, scores)
    print(f"wrote {args.out}: {scores.shape}")


if __name__ == "__main__":
    main()
