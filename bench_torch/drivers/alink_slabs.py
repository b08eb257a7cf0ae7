"""The A-LINK loop, slab after slab: ``ALinkLoop.run_iteration`` over a
pool of synthetic people on the device.

Traffic parameters: ``noise`` (the bank), ``pairs_per_slab`` (one chunk:
``device_batch`` is the same number), ``people_per_slab``, ``people``
in the pool and their ``images_per_person`` range (DFW has ~8.5),
``image`` (h, w, c), ``warmup_slabs``, ``capture_slabs`` drawn from the seed
among the first ``capture_within``, ``check_pairs`` compared per captured
slab, ``de_check_pairs`` of them whose one-pixel attack the reference
scores itself, ``tail_slabs`` for the profiler.

The one-pixel attack draws through ``ops.de.torch_draws`` over the loop's
generator, as it does by default, behind a recorder; the student's
answers to the attack pass through a recorder on the predict function
the loop is given.  For the captured slabs both are kept, with the
committee's labels the attack targets, so that the check can replay the
attack from the program's draws.

A slab's pairs are drawn from the seed among the ordered pairs of its
people's images (genuine where both show one person), so a slab has a
fixed number of pairs, and every seed the same sizes.  A person's images
are one base face (smooth random structure) with image-level changes.

``alink_pairs_per_s``: pairs of the slabs completed in the window over the
time from its start to the end of its last slab; no slab starts after
the deadline.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.tracing import sync
from bench_torch.drivers import Window


def synthetic_people(g, counts, hw, device) -> torch.Tensor:
    """uint8 images (sum(counts), h, w, 3): per person a smooth base face,
    per image a smooth variation and pixel noise."""
    h, w = hw
    p, n = len(counts), int(sum(counts))
    base = F.interpolate(torch.randn((p, 3, 8, 8), generator=g,
                                     device=device), size=(h, w),
                         mode="bicubic", align_corners=False)
    owner = torch.repeat_interleave(torch.arange(p, device=device),
                                    torch.tensor(counts, device=device))
    var = F.interpolate(torch.randn((n, 3, 16, 16), generator=g,
                                    device=device), size=(h, w),
                        mode="bilinear", align_corners=False)
    noise = torch.randn((n, 3, h, w), generator=g, device=device)
    img = 128.0 + 60.0 * base[owner] + 20.0 * var + 6.0 * noise
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)


class Driver:
    def __init__(self, system, traffic: dict, seed: int,
                 device: torch.device):
        self.sys = system
        self.t = traffic
        self.seed = seed
        self.device = device
        self.captured: list[dict] = []
        self.finetunes: list[dict] = []
        self.logs: dict = {}
        self.tail_calls: list[dict] = []   # featurize calls per tail
        self.slab = 0
        self._de = None

    # -- traffic ----------------------------------------------------------

    def _pairs(self, slab: int):
        """The harness's pair_builder: slab index -> (pool, left, right,
        labels), the pool holding the images the pairs use."""
        t = self.t
        k = t["people_per_slab"]
        first = (slab * k) % self.n_people
        people = [(first + i) % self.n_people for i in range(k)]
        imgs = np.concatenate([np.arange(self.starts[p], self.starts[p + 1])
                               for p in people])
        owner = np.concatenate([np.full(self.counts[p], p) for p in people])
        rng = np.random.default_rng([self.seed, slab])
        m = len(imgs)
        flat = rng.choice(m * (m - 1), t["pairs_per_slab"], replace=False)
        a = flat // (m - 1)
        b = flat % (m - 1)
        b = b + (b >= a)                     # ordered pairs, a != b
        used, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
        n = len(a)
        labels = (owner[a] == owner[b]).astype(np.int64)
        return (self.host_pool[imgs[used]], inv[:n], inv[n:], labels)

    def _replay(self):
        """Clean feature pairs mixed into each finetune: batches of
        ``batch_size`` from the replay set, half genuine."""
        rng = np.random.default_rng([self.seed, 1 << 20])
        f, owner = self.replay_feats, self.replay_owner
        bs = self.sys.cfg["loop"]["batch_size"]
        while True:
            i = rng.integers(0, len(owner), bs)
            same = rng.random(bs) < 0.5
            j = np.array([rng.choice(np.flatnonzero(owner == owner[x]))
                          if s else rng.choice(np.flatnonzero(
                              owner != owner[x]))
                          for x, s in zip(i, same)])
            batch = ((f[i], f[j]), (owner[i] == owner[j]).astype(np.int64))
            if self._in_finetune is not None:
                self._in_finetune["replay"].append(batch)
            yield batch

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from alink_tpu_torch.active.loop import ALinkLoop
        from alink_tpu_torch.config import ALinkConfig

        t, cfg = self.t, self.sys.cfg
        rng = np.random.default_rng([self.seed, 7])
        lo, hi = t["images_per_person"]
        self.counts = rng.integers(lo, hi + 1, t["people"] +
                                   t["replay_people"]).tolist()
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + 1)
        imgs = synthetic_people(g, self.counts, t["image"][:2], self.device)
        self.n_people = t["people"]
        self.starts = np.concatenate([[0], np.cumsum(self.counts)])
        n_loop = int(self.starts[self.n_people])
        self.host_pool = imgs[:n_loop].cpu().numpy()
        with torch.no_grad():
            rep = imgs[n_loop:].float()
            self.replay_feats = torch.cat([
                self.sys.featurize(rep[i:i + 256])
                for i in range(0, rep.shape[0], 256)]).cpu().numpy()
        self.replay_owner = np.repeat(np.arange(t["replay_people"]),
                                      self.counts[self.n_people:])
        self._in_finetune = None
        lc = cfg["loop"]
        config = ALinkConfig(
            noise=tuple(t["noise"]), ft_epochs=lc["ft_epochs"],
            batch_size=lc["batch_size"], batch_send=lc["batch_send"],
            mixture_ratio=lc["mixture_ratio"],
            disparity_ratio=lc["disparity_ratio"], eps=lc["eps"],
            image_res=(t["image"][1], t["image"][0]),
            feature_res=cfg["teacher"]["feature_dim"],
            device_batch=t["pairs_per_slab"], seed=self.seed)
        self.sys.committee.noise_names = tuple(t["noise"])
        lg = torch.Generator(device=self.device)
        lg.manual_seed(self.seed + 2)
        hg = torch.Generator()
        hg.manual_seed(self.seed + 3)
        adv = {"pixel_count": cfg["de_pixel_count"],
               "popsize": cfg["de_popsize"], "maxiter": cfg["de_maxiter"],
               "draw": self._recorded_draw(lg)}
        self.loop = ALinkLoop(
            config, featurize=self.sys.featurize,
            committee=self.sys.committee, m2_state=self.sys.m2,
            pair_builder=lambda spec, _: self._pairs(spec),
            replay_gen=self._replay(), pool_uint8=True, generator=lg,
            host_generator=hg,
            adversarial_predict=(self.sys.adversarial_predict
                                 if "adversarial" in t["noise"] else None),
            adversarial_kwargs=adv, device=self.device)
        self._wrap()
        for _ in range(t["warmup_slabs"]):
            self._slab()
        sync(self.device)
        r = random.Random(self.seed)
        self.capture_at = set(self.slab + s for s in r.sample(
            range(t["capture_within"]), t["capture_slabs"]))
        self.sys.images = 0
        self.attack_s = 0.0
        self.loop.state.timings.totals.clear()
        self.loop.state.timings.counts.clear()

    def _recorded_draw(self, generator):
        """The DE's default draws from ``generator``, kept while an attack
        is captured: {(generation, name): tensor}."""
        from alink_tpu_torch.ops.de import torch_draws

        draw = torch_draws(generator, self.device)

        def recorded(step, name, shape, high=None):
            out = draw(step, name, shape, high)
            if self._de is not None:
                self._de["draws"][(step, name)] = out
            return out

        return recorded

    def _wrap(self) -> None:
        """Wrappers on the loop's and the committee's instances: the noise
        bank's synchronised time, and the captures for the check."""
        loop, com = self.loop, self.sys.committee
        chunk, finetune, attack = loop._chunk, loop._finetune, \
            com.attack_model
        predict = loop.adversarial_predict
        self.attack_s = 0.0

        def recorded_predict(m2, left, right):
            out = predict(m2, left, right)
            if self._de is not None:
                self._de["answers"].append(out)
            return out

        def timed_attack(g, left, right, *a, **k):
            snap = g.get_state() if self._cap is not None else None
            if self._cap is not None:
                self._de = {"draws": {}, "answers": []}
            sync(self.device)
            t0 = time.perf_counter()
            out = attack(g, left, right, *a, **k)
            sync(self.device)
            self.attack_s += time.perf_counter() - t0
            if self._cap is not None:
                self._cap.update(gen=snap, noisy=out,
                                 m1_labels=k.get("m1_labels"),
                                 de_draws=self._de["draws"],
                                 de_answers=self._de["answers"])
                self._de = None
            return out

        def captured_chunk(pool, left_idx, right_idx):
            if self.slab in self.capture_at:
                m2 = self.loop.state.m2_state.module
                self._cap = {"slab": self.slab, "pool": pool,
                             "left": left_idx,
                             "right": right_idx,
                             "m2": {k: v.detach().float().clone()
                                    for k, v in m2.state_dict().items()}}
                # The chunk's first two featurize calls are M1's clean
                # halves (one call each: device_batch is the slab).
                self.sys.keep, self.sys.kept = 2, []
            out = chunk(pool, left_idx, right_idx)
            if self._cap is not None:
                self._cap.update(m1=out[0], probs=out[1],
                                 feats=tuple(self.sys.kept))
                self.sys.keep, self.sys.kept = 0, []
                self.captured.append(self._cap)
                self._cap = None
            return out

        def captured_finetune(left_raw, right_raw, pseudo):
            if len(self.finetunes) >= self.t["capture_finetunes"] or \
                    self.slab < min(self.capture_at, default=1 << 62):
                return finetune(left_raw, right_raw, pseudo)
            st = self.loop.state
            m2 = st.m2_state
            rec = {"buffer": (st.buffer_left.copy(), st.buffer_right.copy(),
                              st.buffer_y.copy()),
                   "raw": (left_raw, right_raw), "pseudo": np.array(pseudo),
                   "host": self.loop.host_generator.get_state(),
                   "lr": m2.learning_rate, "replay": [],
                   "before": {k: v.detach().float().clone()
                              for k, v in m2.module.state_dict().items()},
                   "opt": self._adadelta_state(m2)}
            self._in_finetune = rec
            out = finetune(left_raw, right_raw, pseudo)
            self._in_finetune = None
            rec["after"] = {k: v.detach().float().clone()
                            for k, v in m2.module.state_dict().items()}
            self.finetunes.append(rec)
            return out

        self._cap = None
        self.capture_at = set()
        if predict is not None:
            loop.adversarial_predict = recorded_predict
        loop._chunk = captured_chunk
        loop._finetune = captured_finetune
        com.attack_model = timed_attack

    @staticmethod
    def _adadelta_state(m2) -> dict:
        out = {}
        names = dict(m2.module.named_parameters())
        for k, p in names.items():
            s = m2.optimizer.state.get(p, {})
            z = torch.zeros_like(p, dtype=torch.float32)
            out[k] = (s.get("square_avg", z).detach().float().clone(),
                      s.get("acc_delta", z).detach().float().clone())
        return out

    def _slab(self):
        log = self.loop.run_iteration(self.slab, None)
        self.logs[self.slab] = log
        self.slab += 1
        return log

    # -- window -----------------------------------------------------------

    def window(self, seconds: float) -> Window:
        pairs = 0
        first = self.slab
        t0 = time.perf_counter()
        deadline = t0 + seconds
        end = t0
        while time.perf_counter() < deadline:
            pairs += self._slab().pairs
            end = time.perf_counter()
        tm = self.loop.state.timings
        logs = [self.logs[s] for s in range(first, self.slab)]
        return Window({"alink_pairs_per_s": pairs / (end - t0)}, pairs, 0,
                      {"slabs": self.slab - first, "pairs": pairs,
                       "window_s": end - t0, "images": self.sys.images,
                       "attack_s": self.attack_s,
                       "phases": dict(tm.totals),
                       "selected": sum(v.selected for v in logs),
                       "queried": sum(v.queried for v in logs),
                       "finetunes": sum(v.finetuned for v in logs)})

    def tail(self) -> int:
        before = dict(self.sys.calls)
        for _ in range(self.t["tail_slabs"]):
            self._slab()
        self.tail_calls.append({n: c - before.get(n, 0)
                                for n, c in self.sys.calls.items()
                                if c > before.get(n, 0)})
        return self.t["tail_slabs"]

    def release(self) -> None:
        self.loop = None
        self.sys.release()

    def check(self, nx, substitute=None) -> dict:
        from bench_torch.drivers import alink_check

        return alink_check.check(self, nx, substitute)
