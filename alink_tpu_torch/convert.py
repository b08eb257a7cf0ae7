"""JAX-package parameters -> the port's modules.

The JAX modules' parameters arrive as nested dicts of numpy arrays (a flax
``{"params": ...}`` tree after ``jax.tree.map(np.asarray, ...)``).  The
port's modules keep the flax creation order in ``nn.ModuleList``s, so the
mapping is by name:

    Conv_i -> conv.i      (kernel HWIO -> weight OIHW)
    Dense_i -> dense.i, hidden_i -> hidden.i, out -> out
                          (kernel (in, out) -> weight (out, in))
    _FrozenBN_i -> bn.i   (gamma, beta, mean, var)
    _PReLU_i -> prelu.i   (alpha)
    _IRUnit_i -> units.i, _Bottleneck_i -> blocks.i,
    _SEBottleneck_i -> blocks.i
    fc1_gamma, fc1_beta   (unchanged)
    tower, verify_head    (SmallRes's submodules, unchanged)
    backbone              (a classifier's backbone, unchanged)
    SmallResTower_0 -> tower   (SmallResClassifier's tower)

ArcFace, VGG16's pool5 and the SmallRes tower flatten NHWC before their
dense layer in both packages, so that layer needs no permutation beyond
the transpose.

``loop_state_from_jax`` carries a JAX ``ALinkLoop``'s state (student,
Adadelta state, counters, queue) into a port loop.  ``load_insightface_vit``
loads insightface's ViT embedder, which has no JAX counterpart, from its
torch state dict.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_MODULE_NAMES = {"Conv": "conv", "Dense": "dense", "_FrozenBN": "bn",
                 "_PReLU": "prelu", "_IRUnit": "units",
                 "_Bottleneck": "blocks", "_SEBottleneck": "blocks",
                 "hidden": "hidden"}
_SUBMODULES = {"out": "out", "tower": "tower", "verify_head": "verify_head",
               "backbone": "backbone", "SmallResTower_0": "tower"}


def _module_name(key: str) -> str:
    if key in _SUBMODULES:
        return _SUBMODULES[key]
    m = re.fullmatch(r"(.+)_(\d+)", key)
    if m and m.group(1) in _MODULE_NAMES:
        return f"{_MODULE_NAMES[m.group(1)]}.{m.group(2)}"
    raise KeyError(f"no port counterpart for parameter group {key!r}")


def _leaf(name: str, value: np.ndarray) -> tuple[str, torch.Tensor]:
    t = torch.from_numpy(np.array(value, dtype=np.float32))
    if name == "kernel":
        # HWIO -> OIHW for convolutions, (in, out) -> (out, in) for Dense.
        return "weight", t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
    return name, t


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a flax parameter tree into the port's state-dict names."""
    if "params" in params:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + _module_name(key) + ".")
            else:
                name, t = _leaf(key, value)
                out[prefix + name] = t.contiguous()

    walk(params, "")
    return out


def load_flax(module: nn.Module, params: Mapping) -> nn.Module:
    """Load JAX-package parameters into ``module`` (ArcFace, P/R/O/L-Net,
    VGGFaceResNet50, SENet50, VGGFace16, a classifier, SiameseHead or
    SmallRes); every tensor must match by name and shape
    (``load_state_dict(strict=True)`` raises otherwise)."""
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module


_VIT_NORM = re.compile(r"(blocks\.\d+\.norm[12]|norm|feature\.[13])\."
                       r"(weight|bias|running_mean|running_var)")
_VIT_LEAF = {"weight": "gamma", "bias": "beta", "running_mean": "mean",
             "running_var": "var"}


def load_insightface_vit(module: nn.Module,
                         state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load an insightface ``arcface_torch`` ViT ``state_dict``
    (``backbones/vit.py``: ``patch_embed.proj.*``, ``pos_embed``,
    ``blocks.<i>.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}.*``,
    ``norm.*``, ``feature.{0,1,2,3}.*``) into a ``models.FaceViT``.  The
    LayerNorm and BatchNorm1d leaves ``weight``/``bias``/``running_mean``/
    ``running_var`` become ``gamma``/``beta``/``mean``/``var``;
    ``num_batches_tracked`` and the training-only ``mask_token`` are
    dropped; every other name is the port's.  Tensors are copied into the
    module's dtypes; names and shapes must match (``strict=True``)."""
    out = {}
    for key, t in state_dict.items():
        if key == "mask_token" or key.endswith(".num_batches_tracked"):
            continue
        m = _VIT_NORM.fullmatch(key)
        out[f"{m.group(1)}.{_VIT_LEAF[m.group(2)]}" if m else key] = t
    module.load_state_dict(out, strict=True)
    return module


def loop_state_from_jax(loop, m2_params: Mapping, opt_state, counters,
                        buffers: Mapping | None = None) -> None:
    """Fill the port ``ALinkLoop`` ``loop``'s state from a JAX loop's, given
    as numpy trees (``jax.tree.map(np.asarray, ...)``): what the JAX loop's
    ``save`` writes, handed over as arrays (its Orbax checkpoint directory is
    not read here).

    - ``m2_params``: the student's flax parameters (``state_dict_from_flax``);
    - ``opt_state``: its optax state, ``inject_hyperparams(adadelta)``: the
      ``ScaleByAdaDeltaState``'s ``e_g`` and ``e_x`` become
      ``torch.optim.Adadelta``'s ``square_avg`` and ``acc_delta`` (the same
      update, ``trainer.adadelta``), the injected learning rate the
      optimizer's ``lr``, ``count`` its step;
    - ``counters``: ``[active_count, un_size, pool_cursor, replay_draws,
      completed iterations]`` (``ALinkLoop.load_counters``, which also
      fast-forwards the port loop's replay generator);
    - ``buffers``: ``buffer_left``/``_right``/``_y`` of the queue, or None
      for an empty one.

    The RNG cannot be carried: the JAX loop's threefry key has no Philox
    counterpart, so the port loop's generators keep their own states.
    """
    m2 = loop.state.m2_state
    m2.module.load_state_dict(state_dict_from_flax(m2_params), strict=True)
    ada = next(s for s in opt_state.inner_state if hasattr(s, "e_g"))
    square_avg = state_dict_from_flax(ada.e_g)
    acc_delta = state_dict_from_flax(ada.e_x)
    count = int(np.asarray(opt_state.count))
    lr = float(np.asarray(opt_state.hyperparams["learning_rate"]).reshape(-1)[0])
    opt = m2.optimizer
    for name, p in m2.module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "square_avg": square_avg[name].to(p.device, p.dtype),
            "acc_delta": acc_delta[name].to(p.device, p.dtype)}
    for group in opt.param_groups:
        group["lr"] = lr
    m2.step = count
    loop.load_counters(counters)
    loop.load_queue(buffers or {})
