"""Random weights made on the device from the seed, in a few large calls.

A module is built on the ``meta`` device (no memory, no host draws),
moved to the card uninitialised, and every parameter and buffer is then
filled by one rule from its name and shape:

- a convolution or dense kernel (2 or more dims): N(0, 1/fan_in);
- a bias: 0;
- a PReLU slope (``alpha``): 0.25;
- batch-norm statistics: gamma U(0.8, 1.2), beta N(0, 0.1^2),
  mean N(0, 0.1^2), var U(0.8, 1.2), var times ``input_var`` for the BN
  that follows a stem convolution on raw pixels (so that it normalises).

All normal draws come from one ``torch.randn`` and all uniform draws from
one ``torch.rand`` on a generator on the card.  The same dict of tensors
feeds the program's modules and the plain references.
"""

from __future__ import annotations

import torch
from torch import nn


def on_meta(build):
    """``build()`` on the meta device."""
    with torch.device("meta"):
        return build()


def _rule(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("gamma") or leaf == "var":
        return "uniform"
    if leaf.endswith("beta") or leaf == "mean":
        return "small"
    if leaf == "alpha":
        return "alpha"
    if leaf == "bias":
        return "zero"
    if len(shape) >= 2:
        return "kernel"
    return "zero"


def fill(module: nn.Module, generator: torch.Generator,
         device: torch.device, stem_bn: dict[str, float] | None = None
         ) -> dict[str, torch.Tensor]:
    """Materialise ``module`` (built on meta) on ``device`` and fill it;
    returns its state dict (the tensors the module holds).

    ``stem_bn``: {BN prefix: input variance} for the BNs whose ``var`` is
    scaled to the variance of the raw pixels they see."""
    module.to_empty(device=device)
    state = {k: v for k, v in module.state_dict(keep_vars=True).items()}
    normal = [(k, v) for k, v in state.items()
              if _rule(k, tuple(v.shape)) in ("kernel", "small")]
    uniform = [(k, v) for k, v in state.items()
               if _rule(k, tuple(v.shape)) == "uniform"]
    with torch.no_grad():
        z = torch.randn(sum(v.numel() for _, v in normal),
                        generator=generator, device=device)
        u = torch.rand(max(1, sum(v.numel() for _, v in uniform)),
                       generator=generator, device=device)
        i = 0
        for k, v in normal:
            n = v.numel()
            part = z[i:i + n].view(v.shape)
            i += n
            if _rule(k, tuple(v.shape)) == "kernel":
                fan_in = v[0].numel()
                v.copy_(part * fan_in ** -0.5)
            else:
                v.copy_(part * 0.1)
        i = 0
        for k, v in uniform:
            n = v.numel()
            v.copy_(0.8 + 0.4 * u[i:i + n].view(v.shape))
            i += n
        for k, v in state.items():
            r = _rule(k, tuple(v.shape))
            if r == "zero":
                v.zero_()
            elif r == "alpha":
                v.fill_(0.25)
        for prefix, var in (stem_bn or {}).items():
            state[prefix + ".var"].mul_(var)
    return {k: v.detach() for k, v in module.state_dict().items()}


def centre_head(head: nn.Module, input_scale: float) -> None:
    """A siamese head as trained heads respond: every unit's kernel centred
    over its inputs (|l - r| and the ReLU outputs are never negative, so
    an uncentred random head answers the same for every pair), and the
    first layer scaled so that |l - r| enters at about unit size."""
    with torch.no_grad():
        for lin in list(head.hidden) + [head.out]:
            lin.weight.sub_(lin.weight.mean(dim=1, keepdim=True))
        head.hidden[0].weight.mul_(input_scale)


def blend(head: nn.Module, like: nn.Module, rho: float) -> None:
    """``head``'s kernels := rho * ``like``'s + sqrt(1 - rho^2) * its own
    (both drawn alike, so the norms stay)."""
    with torch.no_grad():
        for (name, p), q in zip(head.named_parameters(), like.parameters()):
            if name.endswith("weight"):
                p.mul_((1.0 - rho * rho) ** 0.5).add_(q, alpha=rho)
