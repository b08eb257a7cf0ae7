"""Convert the reference's Keras ``save_weights`` .h5 siamese heads to the
port's ``SiameseHead`` state dicts (counterpart of
``alink_tpu/tools/convert_weights.py``).

The reference releases its trained verification heads as Keras-2 weight
files (``disguisedModel.h5``, ``ensemble*.h5``) written by
``SiameseNetwork.save`` (code/siamese.py:121-125): three Dense layers on the
|l - r| feature difference (siamese.py:29-32), which map 1:1 onto
``models.SiameseHead``:

    dense_1 (D -> 512)  -> hidden.0
    dense_2 (512 -> 64) -> hidden.1
    dense_3 (64 -> 2)   -> out        (or Dense(1) for the py3 variant)

Keras ``save_weights`` layout (HDF5): root attr ``layer_names``; one group
per layer with attr ``weight_names`` (e.g. ``dense_1/kernel:0``) naming
the datasets.  Keras kernels are (in, out); the port's weights are
(out, in).  ``h5py`` is imported only when a file is read.

CLI (writes the state dict with ``train.checkpoint.save``, a directory)::

    python -m alink_tpu_torch.tools.convert_weights siamese model.h5 out_ckpt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alink_tpu_torch.convert import state_dict_from_flax


def _decode(names) -> list[str]:
    return [n.decode() if isinstance(n, bytes) else str(n) for n in names]


def read_keras_dense_layers(h5_path: str) -> list[tuple[np.ndarray,
                                                        np.ndarray]]:
    """(kernel, bias) of every Dense layer, in topology order."""
    import h5py

    layers = []
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name in _decode(root.attrs["layer_names"]):
            group = root[name]
            weight_names = _decode(group.attrs.get("weight_names", []))
            kernels = [w for w in weight_names if "kernel" in w]
            biases = [w for w in weight_names if "bias" in w]
            if kernels and biases:
                layers.append((np.array(group[kernels[0]]),
                               np.array(group[biases[0]])))
    return layers


def siamese_h5_to_state_dict(h5_path: str) -> dict[str, torch.Tensor]:
    """A ``SiameseHead`` state dict from a reference weight file."""
    dense = read_keras_dense_layers(h5_path)
    if len(dense) != 3:
        raise ValueError(
            f"expected 3 Dense layers (siamese.py:29-32), found {len(dense)}")
    (k1, b1), (k2, b2), (k3, b3) = dense
    return state_dict_from_flax({
        "hidden_0": {"kernel": k1, "bias": b1},
        "hidden_1": {"kernel": k2, "bias": b2},
        "out": {"kernel": k3, "bias": b3}})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("kind", choices=("siamese",),
                        help="model family to convert")
    parser.add_argument("h5_path")
    parser.add_argument("out_ckpt")
    args = parser.parse_args(argv)
    state = siamese_h5_to_state_dict(args.h5_path)
    from alink_tpu_torch.train.checkpoint import save

    save(args.out_ckpt, state)
    print(f"wrote {args.out_ckpt}")


if __name__ == "__main__":
    main()
