"""The ArcFace A-LINK driver (``drivers/alink_arc.py``) and its
configuration against the JAX package, on the CPU.

- ``ALinkArcConfig``: fields, defaults, types and validation equal to
  JAX's, flag for flag through ``parse_config``;
- ``make_arcface_featurizer``: the zoo's stage sizes at depths 34, 50 and
  100; a JAX tree and a torch state dict load to the JAX featurizer's
  output (1e-4 on unit-norm embeddings, f32);
- ``main`` at toy scale: ArcFace (1, 1, 1, 1) at 112x112 with the same
  weights on both sides, the default six-channel bank (perlin and the
  one-pixel attack, cut to ``test_torch_port_a2.CPU_DE``), f32 heads,
  against the JAX driver's run of the same synthetic tree.  Both loops
  start from the same pretrained M2 and committee (the JAX driver's
  checkpoints, converted), and the JAX loop's key schedule is replayed
  into the port's: each chunk's noise draws and DE draws
  (``test_torch_port_a2.jax_draws``) and each finetune's permutations.
  Every slab's log (pairs, selected, queried, active count, pool size,
  finetuned) is equal, and the final M2 is within 1e-3 of its update's
  largest change, as in ``test_torch_port_alink.py``.

The seed: one pixel moves the toy's P(genuine) by 4e-6 to 2e-4 (20
random pixels), so two DE candidates' energies can lie closer than the
frameworks' f32 differences (about 1e-7 on the embeddings).  With the
config's seed 42 the first slab's attack takes another pixel for one pair
in the two packages; seeds 1, 2 and 3 have no such tie (the final M2
within 2e-5 to 7e-5 of the update scale), and the test runs seed 1.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alink_tpu.config import ALinkArcConfig as JALinkArcConfig
from alink_tpu.drivers import alink as jalink
from alink_tpu.drivers import alink_arc as jarc
from alink_tpu.drivers import common as jcommon
from alink_tpu.models import ArcFaceResNet100 as JArcFace
from alink_tpu.models import SiameseHead as JSiameseHead
from alink_tpu.train import checkpoint as jT
from alink_tpu_torch import config as tconfig
from alink_tpu_torch.active import loop as tloop
from alink_tpu_torch.convert import load_flax, state_dict_from_flax
from alink_tpu_torch.drivers import alink as talink
from alink_tpu_torch.drivers import alink_arc as tarc
from alink_tpu_torch.drivers import common as tcommon
from alink_tpu_torch.models import ArcFaceResNet100, SiameseHead
from alink_tpu_torch.ops import noise
from alink_tpu_torch.train import checkpoint as T

from test_torch_port_a2 import (CPU_DE, _cut_de, jax_draws,  # noqa: F401
                                pil_only)

WIDTHS = (16, 16, 32, 32)
# The toy run: no grey band and half of each channel's pairs, so that both
# slabs query pairs and M2 is finetuned; a seed without a near-tie (module
# docstring).
SELECTION = ("--eps", "0", "--disparity_ratio", "0.5")
TOY_SEED = 1


def test_arc_config_matches_jax_field_by_field():
    jf = {f.name: f for f in dataclasses.fields(JALinkArcConfig)}
    tf = {f.name: f for f in dataclasses.fields(tconfig.ALinkArcConfig)}
    assert list(jf) == list(tf)
    for name in jf:
        assert tf[name].default == jf[name].default, name
        assert str(tf[name].type) == str(jf[name].type), name
    cfg = talink.parse_config([], config_cls=tconfig.ALinkArcConfig)
    assert cfg == tconfig.ALinkArcConfig()
    assert cfg.image_res == (112, 112) and cfg.feature_res == 512
    assert "perlin" in cfg.noise and cfg.noise[-1] == "adversarial"
    for argv in (["--embed_depth", "50"], ["--embed_scan_units", "true"]):
        assert (dataclasses.asdict(talink.parse_config(
            argv, config_cls=tconfig.ALinkArcConfig))
            == dataclasses.asdict(jalink.parse_config(
                argv, config_cls=JALinkArcConfig)))
    for bad in (["--embed_depth", "18"], ["--eps", "0.7"]):
        with pytest.raises(ValueError):
            jalink.parse_config(bad, config_cls=JALinkArcConfig)
        with pytest.raises(ValueError):
            talink.parse_config(bad, config_cls=tconfig.ALinkArcConfig)


@pytest.mark.parametrize("depth,sizes", [(34, (3, 4, 6, 3)),
                                         (50, (3, 4, 14, 3)),
                                         (100, (3, 13, 30, 3))])
def test_make_arcface_featurizer_builds_the_zoo(depth, sizes):
    featurize, model = tarc.make_arcface_featurizer(
        torch.Generator().manual_seed(0), depth=depth, device="cpu")
    assert model.stage_sizes == sizes == jarc._DEPTHS[depth]().stage_sizes
    assert len(model.units) == sum(sizes) and model.embedding_dim == 512
    assert not any(p.requires_grad for p in model.parameters())
    assert callable(featurize)


def _tiny_arcface():
    """ArcFace (1, 1, 1, 1) 512-d in f32: the JAX model and its tree."""
    jm = JArcFace(stage_sizes=(1, 1, 1, 1), stage_widths=WIDTHS,
                  dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 112, 112, 3)))
    return jm, jax.tree.map(np.asarray, p)


def _tiny_port(generator=None, device=None):
    return ArcFaceResNet100(stage_sizes=(1, 1, 1, 1), stage_widths=WIDTHS,
                            dtype=torch.float32, generator=generator,
                            device=device)


def test_featurizer_loads_jax_trees_and_state_dicts(monkeypatch):
    jm, p = _tiny_arcface()
    monkeypatch.setitem(tarc._DEPTHS, 100, _tiny_port)
    x = np.random.default_rng(8).uniform(0, 255, (2, 112, 112, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    feat, model = tarc.make_arcface_featurizer(None, params=p, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(feat(torch.from_numpy(x)).numpy(), want,
                                   atol=1e-4)
    feat2, _ = tarc.make_arcface_featurizer(
        torch.Generator().manual_seed(3), params=model.state_dict(),
        device="cpu")
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = feat2(x_t)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-4)
    # Frozen weights, differentiable pixels (FGSM and the model channels).
    out.sum().backward()
    assert x_t.grad is not None and bool(torch.isfinite(x_t.grad).all())


# -- the JAX loop's key schedule, fed to the port's loop ---------------------

def _port_noise(name, key, width, x):
    """Channel ``name`` on the port's ``(n, h, w, c)`` rows ``x`` with the
    draws that the JAX channel makes from ``key`` on the chunk padded to
    ``width`` rows (the JAX loop pads a chunk to a power of two by
    repeating its last pair; its first ``n`` rows are the real ones)."""
    n, h, w, c = x.shape
    shape = (width, h, w, c)
    if name in ("gaussian", "speckle"):
        z = torch.from_numpy(np.asarray(
            jax.random.normal(key, shape, jnp.float32))[:n])
        return (noise.gaussian_from if name == "gaussian"
                else noise.speckle_from)(x, z)
    per = jax.random.split(key, width)[:n]
    if name == "poisson":
        z = jax.vmap(lambda k: jax.random.normal(k, shape[1:],
                                                 jnp.float32))(per)
        return noise.poisson_from(x, torch.from_numpy(np.asarray(z)))
    if name == "saltpepper":
        counts = noise.salt_pepper_counts(shape)

        def one(k):
            return [jnp.stack([jax.random.randint(kk, (count,), 0, hi - 1)
                               for kk, hi in zip(jax.random.split(k2, 3),
                                                 (h, w, c))])
                    for k2, count in zip(jax.random.split(k), counts)]

        salt, pepper = (torch.from_numpy(np.asarray(a)).permute(1, 0, 2)
                        for a in jax.vmap(one)(per))
        return noise.salt_pepper_from(x, salt, pepper)
    assert name == "perlin", name
    phis = [[] for _ in noise.perlin_octaves(h)]
    for k in per:
        for j, (kk, ns) in enumerate(zip(jax.random.split(k, 3),
                                         noise.perlin_octaves(h))):
            nc = -(-h // ns)
            phis[j].append(np.asarray(jax.random.uniform(
                kk, (nc + 1, nc + 1), minval=0.0, maxval=2 * jnp.pi)))
    return noise.perlin_from(x, [torch.from_numpy(np.stack(p))
                                 for p in phis])


class _JaxSchedule:
    """The JAX loop's keys, in the order it splits them off (a chunk's key
    with its padded width, or a finetune's key), replayed into the port's
    loop: each chunk's noise channels and one-pixel DE, and each
    finetune's epoch permutations."""

    def __init__(self):
        self.records = []
        self.noise_keys, self.width, self.de = {}, 0, None

    def jax_loop(self, base, loops):
        sched = self

        class Recorded(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.chunk_width = None
                loops.append(self)

            def _process_chunk(self, pool, left_idx, right_idx):
                self.chunk_width = int(left_idx.shape[0])
                return super()._process_chunk(pool, left_idx, right_idx)

            def _next_key(self):
                key = super()._next_key()
                sched.records.append((key, self.chunk_width))
                self.chunk_width = None
                return key

        return Recorded

    def port_loop(self, base, loops):
        sched = self

        class Fed(base):
            def __init__(self, *a, **k):
                super().__init__(*a, adversarial_kwargs=dict(
                    CPU_DE, draw=lambda *d: sched.de(*d)), **k)
                loops.append(self)

            def _chunk(self, pool, left_idx, right_idx):
                sched.start_chunk(self.committee.noise_names,
                                  int(left_idx.shape[0]))
                return super()._chunk(pool, left_idx, right_idx)

        return Fed

    def _pop(self, chunk: bool):
        key, width = self.records.pop(0)
        assert (width is not None) == chunk, "the key schedules diverged"
        return key, width

    def start_chunk(self, names, n):
        """``Committee.attack_model``'s split: the plain bank's key, then
        the one-pixel attack's; per channel a (left, right) pair."""
        key, self.width = self._pop(chunk=True)
        kb, rest = jax.random.split(key)
        plain = [nm for nm in names if nm not in ("adversarial", "fgsm")]
        self.noise_keys = {nm: list(jax.random.split(k)) for nm, k in
                           zip(plain, jax.random.split(kb, len(plain)))}
        ka = jax.random.split(rest)[0]
        k = 5 * CPU_DE["pixel_count"]       # (x, y, r, g, b) per pixel
        m = max(5, max(1, CPU_DE["popsize"] // k) * k)
        self.de = jax_draws(jax.random.split(ka, self.width)[:n], m, k,
                            CPU_DE["maxiter"])

    def noise_fn(self, name):
        return lambda g, x: _port_noise(name, self.noise_keys[name].pop(0),
                                        self.width, x)

    def fit(self, real_fit, monkeypatch):
        """The port's ``fit`` shuffling with JAX ``fit``'s permutations
        (an epoch splits one key for its permutation, then one per step)."""
        def fit(state, left, right, labels, *, epochs, batch_size,
                generator=None, **kw):
            key, _ = self._pop(chunk=False)
            n_train = int(len(labels) * 0.8) or len(labels)
            perms = []
            for _ in range(epochs):
                key, kp = jax.random.split(key)
                perms.append(torch.from_numpy(np.asarray(
                    jax.random.permutation(kp, n_train))).long())
                for _ in range(max(1, -(-n_train // batch_size))):
                    key, _ = jax.random.split(key)
            with monkeypatch.context() as m:
                m.setattr(torch, "randperm",
                          lambda n, generator=None: perms.pop(0))
                return real_fit(state, left, right, labels, epochs=epochs,
                                batch_size=batch_size, **kw)
        return fit


def test_alink_arc_main_matches_jax(tmp_path, monkeypatch, pil_only):
    jm, p = _tiny_arcface()
    monkeypatch.setattr(jarc, "make_arcface_featurizer",
                        lambda key, depth, scan_units: (
                            jax.jit(lambda x: jm.apply(p, x)), p))
    monkeypatch.setitem(tarc._DEPTHS, 100, lambda generator, device:
                        load_flax(_tiny_port(device=device), p))
    # f32 heads on both sides (run_alink's are bf16): the comparison then
    # sees the loop and not two frameworks' bf16 roundings.
    monkeypatch.setattr(jcommon, "SiameseHead", functools.partial(
        JSiameseHead, dtype=jnp.float32))
    monkeypatch.setattr(tcommon, "SiameseHead", functools.partial(
        SiameseHead, dtype=torch.float32))
    sched = _JaxSchedule()
    jloops, tloops = [], []
    _cut_de(jalink, monkeypatch)
    monkeypatch.setattr(jalink, "ALinkLoop",
                        sched.jax_loop(jalink.ALinkLoop, jloops))
    monkeypatch.setattr(talink, "ALinkLoop",
                        sched.port_loop(talink.ALinkLoop, tloops))
    monkeypatch.setattr(noise, "get_relevant_noise", sched.noise_fn)
    monkeypatch.setattr(tloop, "fit", sched.fit(tloop.fit, monkeypatch))

    def argv(side, *extra):
        return ["--synthetic_people", "4", "--dig_epochs", "1",
                "--undig_epochs", "1", "--ft_epochs", "2", "--alink_bs", "2",
                "--batch_send", "4", "--batch_size", "8",
                "--train_steps", "32", "--num_ensemble_models", "2",
                *SELECTION, "--seed", str(TOY_SEED),
                "--out_model", str(tmp_path / side / "post"),
                "--ensemble_basepath", str(tmp_path / side / "ens"),
                "--disguised_basemodel", str(tmp_path / side / "dig"),
                *extra]

    # The first JAX run pretrains M2 and the committee and saves them; the
    # port loads them, as the second JAX run does, so the loops start from
    # the same heads with fresh optimizers.
    jarc.main(argv("j", "--active_ratio", "0"))
    for name in ["dig", "ens1", "ens2"]:
        T.save(str(tmp_path / "t" / name), state_dict_from_flax(
            jax.tree.map(np.asarray, jT.restore(str(tmp_path / "j" / name)))))
    start = T.restore(str(tmp_path / "t" / "dig"))
    del sched.records[:]
    jarc.main(argv("j"))
    tarc.main(argv("t", "--device", "cpu"))
    assert not sched.records, "the port's loop drew fewer keys than JAX's"

    jl, tl = jloops[-1], tloops[0]
    assert tl.config.noise == jl.config.noise == JALinkArcConfig().noise
    assert "perlin" in tl.config.noise and {
        k: v for k, v in tl.adversarial_kwargs.items() if k != "draw"} == CPU_DE
    assert len(tl.logs) >= 2 and tl.logs == jl.logs, (tl.logs, jl.logs)
    assert tl.state.active_count > 0 and any(lg.finetuned for lg in tl.logs)
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, jT.restore(str(tmp_path / "j" / "post"))))
    got = T.restore(str(tmp_path / "t" / "post"))
    scale = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert scale > 0
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-3 * scale, k


def test_alink_arc_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tarc.main(["--synthetic_people", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tarc.make_arcface_featurizer(None, depth=34)
