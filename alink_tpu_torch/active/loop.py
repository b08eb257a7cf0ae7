"""The A-LINK loop (counterpart of ``alink_tpu/active/loop.py``; the
reference's ALINK.py:145-259).  Per slab of ``alink_bs`` unlabeled persons:

1. build the all-pairs slab (plain x disguised + disguised x disguised);
   its ground-truth labels act as the pseudo-oracle;
2. in chunks of at most ``device_batch`` pairs: gather the pairs from the
   device-resident pool, featurize, committee (M1) probabilities and
   one-hot labels, the noise bank on the raw pixels (its model channels
   attack the live student toward M1's labels; grad is enabled only
   inside FGSM), student (M2) probabilities per channel;
3. disparity selection, all-noise intersection and the oracle gate
   (``active.selection``, with the host-exact take count ``int(n * ratio)``);
4. queue equal per-noise shares of the queried pairs;
5. once the queue holds ``batch_send`` pairs: add the clean queried pairs
   and ``mixture_ratio`` replay batches, finetune M2 with ``fit`` (batch 16),
   flush;
6. stop once ACTIVE_COUNT >= active_ratio * UN_SIZE.

PyTorch runs eagerly, so the JAX package's shape bucketing (pool rows,
chunk widths, gathers), which exists to bound recompiles, is not ported:
chunks take their real width.  Not ported yet, and raising
``NotImplementedError`` when asked for (ROADMAP.md queue item 1): loop
``save``/``restore``/resume, ``augment=True``, ``debug_nans``,
``device_batch="auto"`` and the multi-host heartbeat; the raw-pixel student
of the Multi-PIE driver (``student_featurize=None``) waits with that driver.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.active.selection import select_queries
from alink_tpu_torch.data.loader import PersonStacks
from alink_tpu_torch.data.pairs import all_pairs_index
from alink_tpu_torch.ops.image import resize
from alink_tpu_torch.ops.pairwise import pair_scores
from alink_tpu_torch.train.trainer import TrainState, fit
from alink_tpu_torch.utils.profiling import Timings

NOT_PORTED = ("{} is not ported yet (ROADMAP.md, queue item 1: loop resume, "
              "augment and the debug and multi-host knobs)")


@dataclasses.dataclass
class ALinkState:
    """Loop state: the student, the oracle accounting, the queue, and the
    loop's records (one ``IterationLog`` per slab, per-phase ``timings``)."""

    m2_state: TrainState
    active_count: int = 0
    un_size: int = 0
    pool_cursor: int = 0
    buffer_left: np.ndarray | None = None
    buffer_right: np.ndarray | None = None
    buffer_y: np.ndarray | None = None
    logs: list = dataclasses.field(default_factory=list)
    timings: Timings = dataclasses.field(default_factory=Timings)

    def buffer_size(self) -> int:
        return 0 if self.buffer_y is None else int(len(self.buffer_y))

    def append_buffer(self, left, right, y):
        if self.buffer_size() == 0:
            self.buffer_left = np.asarray(left)
            self.buffer_right = np.asarray(right)
            self.buffer_y = np.asarray(y)
        else:
            self.buffer_left = np.concatenate([self.buffer_left, left])
            self.buffer_right = np.concatenate([self.buffer_right, right])
            self.buffer_y = np.concatenate([self.buffer_y, y])

    def flush_buffer(self):
        self.buffer_left = self.buffer_right = self.buffer_y = None


class IterationLog(NamedTuple):
    iteration: int
    pairs: int
    selected: int
    queried: int
    active_count: int
    un_size: int
    finetuned: bool


class ALinkLoop:
    """Host orchestrator of the A-LINK loop.

    Args:
        config: an ``alink_tpu_torch.config.ALinkConfig``.
        featurize: ``(N, H, W, C) f32 tensor -> (N, D)`` on ``device``;
            M1 and the M2 student share it (the DFW drivers).
        committee: the M1 ensemble over feature pairs.
        m2_state: the student's ``TrainState`` (a ``SiameseHead``).
        replay_gen: iterator of clean ``((left, right), y)`` feature batches
            mixed into each finetune.
        device_batch: pairs per chunk (default ``config.device_batch``).
        pool_uint8: keep the slab's image pool uint8 on the device.
        generator: noise draws, on ``device`` (seeded from ``config.seed``
            when omitted); finetune shuffles use ``host_generator``.
        adversarial_predict: the student end to end, ``(m2 module, left,
            right) -> (N, 2)`` probabilities on raw pixels, for the model
            channels of the noise bank (``drivers.alink.
            make_adversarial_predict``); ``adversarial_kwargs`` go to the
            one-pixel attack.
        device: where the pool and all tensor work live (default: the
            student's device).
    """

    def __init__(self, config, *, featurize: Callable, committee: Committee,
                 m2_state: TrainState, replay_gen: Iterator | None = None,
                 device_batch: int | None = None, pool_uint8: bool = False,
                 generator: torch.Generator | None = None,
                 host_generator: torch.Generator | None = None,
                 adversarial_predict: Callable | None = None,
                 adversarial_kwargs: dict | None = None,
                 device=None):
        db = device_batch if device_batch is not None else getattr(
            config, "device_batch", 1024)
        if db == "auto":
            raise NotImplementedError(NOT_PORTED.format(
                'device_batch="auto"'))
        if getattr(config, "augment", False):
            raise NotImplementedError(NOT_PORTED.format("augment=True"))
        if getattr(config, "debug_nans", False):
            raise NotImplementedError(NOT_PORTED.format("debug_nans"))
        self.config = config
        self.device_batch = int(db)
        self.featurize = featurize
        self.committee = committee
        self.adversarial_predict = adversarial_predict
        self.adversarial_kwargs = adversarial_kwargs
        # The noisy pairs are resized to the student's (h, w); the config
        # holds cv2's (w, h).
        self.student_res = (config.image_res[1], config.image_res[0])
        self.replay_gen = replay_gen
        self.pool_uint8 = pool_uint8
        self.device = torch.device(device) if device is not None \
            else m2_state.device
        self.generator = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(config.seed)
        self.host_generator = host_generator if host_generator is not None \
            else torch.Generator().manual_seed(config.seed)
        self.state = ALinkState(m2_state=m2_state,
                                timings=Timings(self.device))

    @property
    def logs(self) -> list[IterationLog]:
        return self.state.logs

    @property
    def timings(self) -> Timings:
        return self.state.timings

    # -- helpers ---------------------------------------------------------

    def _features(self, images: torch.Tensor) -> torch.Tensor:
        """Featurize in pieces of at most ``device_batch`` images."""
        db = self.device_batch
        return torch.cat([self.featurize(images[i:i + db])
                          for i in range(0, images.shape[0], db)])

    def _chunk(self, pool, left_idx, right_idx):
        """One chunk: pool gather, M1 features and probabilities, noise
        bank, student probabilities per channel."""
        left_raw = pool[left_idx].float()
        right_raw = pool[right_idx].float()
        m1 = self.committee.predict(self._features(left_raw),
                                    self._features(right_raw))
        m1_labels = torch.nn.functional.one_hot(
            torch.argmax(m1, dim=-1), 2).float()
        # The attacks target the live student (noise.py:153-168).
        noisy_l, noisy_r = self.committee.attack_model(
            self.generator, left_raw, right_raw, self.student_res,
            m1_labels=m1_labels,
            adversarial_predict=self.adversarial_predict,
            adversarial_params=self.state.m2_state.module,
            adversarial_kwargs=self.adversarial_kwargs)
        k, nc = noisy_l.shape[:2]
        sli = self._features(noisy_l.reshape((-1,) + noisy_l.shape[2:]))
        sri = self._features(noisy_r.reshape((-1,) + noisy_r.shape[2:]))
        probs = pair_scores(self.state.m2_state.module, sli, sri)
        return (m1[:, 1], probs.reshape(k, nc), sli.reshape(k, nc, -1),
                sri.reshape(k, nc, -1))

    # -- one slab --------------------------------------------------------

    def run_iteration(self, plain_part: PersonStacks,
                      dig_part: PersonStacks) -> IterationLog:
        cfg = self.config
        dev = self.device
        with self.timings.phase("pairs"):
            flat, left_idx, right_idx, y = all_pairs_index(plain_part,
                                                           dig_part)
            pool_np = np.asarray(flat)
            if self.pool_uint8:
                pool_np = np.clip(pool_np, 0, 255).astype(np.uint8)
            pool = torch.as_tensor(pool_np, device=dev)
            left_t = torch.as_tensor(left_idx, device=dev).long()
            right_t = torch.as_tensor(right_idx, device=dev).long()
        n = len(y)
        if n == 0:
            raise ValueError(
                "the slab has no pairs: every slab "
                "part must contribute at least one person with images")
        self.state.un_size += n

        db = self.device_batch
        with self.timings.phase("chunk"), torch.no_grad():
            parts = [self._chunk(pool, left_t[s:s + db], right_t[s:s + db])
                     for s in range(0, n, db)]
            m1_genuine = torch.cat([p[0] for p in parts])
            student_probs = torch.cat([p[1] for p in parts], dim=1)
            student_l = torch.cat([p[2] for p in parts], dim=1)
            student_r = torch.cat([p[3] for p in parts], dim=1)
        k_noise = student_probs.shape[0]

        with self.timings.phase("select"):
            sel = select_queries(
                student_probs, m1_genuine,
                torch.as_tensor(np.asarray(y, np.float32), device=dev),
                disparity_ratio=cfg.disparity_ratio,
                blind_strategy=cfg.blind_strategy, eps=cfg.eps,
                valid=torch.ones(n, dtype=torch.bool, device=dev),
                k_take=int(n * cfg.disparity_ratio))
            queried = torch.nonzero(sel.queried).flatten().cpu().numpy()
            selected_count = int(sel.selected.sum())
            self.state.active_count += int(sel.oracle_charges)

        finetuned = False
        if queried.size:
            pseudo = sel.pseudo_labels.cpu().numpy()[queried].astype(np.int32)
            # Equal per-noise shares of the (ascending) queried rows.
            mp = queried.size // k_noise
            for k in range(k_noise if mp else 0):
                rows = torch.as_tensor(queried[k * mp:(k + 1) * mp],
                                       device=dev)
                self.state.append_buffer(student_l[k, rows].cpu().numpy(),
                                         student_r[k, rows].cpu().numpy(),
                                         pseudo[k * mp:(k + 1) * mp])
            if self.state.buffer_size() >= cfg.batch_send:
                finetuned = True
                with self.timings.phase("finetune"):
                    q = torch.as_tensor(queried, device=dev)
                    self._finetune(pool[left_t[q]].float(),
                                   pool[right_t[q]].float(), pseudo)

        log = IterationLog(iteration=len(self.logs), pairs=n,
                           selected=selected_count, queried=int(queried.size),
                           active_count=self.state.active_count,
                           un_size=self.state.un_size, finetuned=finetuned)
        self.logs.append(log)
        return log

    def _finetune(self, left_raw, right_raw, pseudo):
        """Queue + clean queried pairs + replay, then ``fit`` M2 (batch 16,
        ALINK.py:251) and flush the queue."""
        cfg = self.config
        parts_l = [self.state.buffer_left]
        parts_r = [self.state.buffer_right]
        parts_y = [self.state.buffer_y]
        with torch.no_grad():
            parts_l.append(self._features(
                resize(left_raw, self.student_res)).cpu().numpy())
            parts_r.append(self._features(
                resize(right_raw, self.student_res)).cpu().numpy())
        parts_y.append(np.asarray(pseudo))
        if self.replay_gen is not None:
            for _ in range(cfg.mixture_ratio):
                (rl, rr), ry = next(self.replay_gen)
                parts_l.append(np.asarray(rl))
                parts_r.append(np.asarray(rr))
                parts_y.append(np.asarray(ry).reshape(-1))
        self.state.m2_state, _ = fit(
            self.state.m2_state, np.concatenate(parts_l),
            np.concatenate(parts_r),
            np.concatenate(parts_y).astype(np.int64), epochs=cfg.ft_epochs,
            batch_size=16, generator=self.host_generator)
        self.state.flush_buffer()

    # -- full run --------------------------------------------------------

    def save(self, path: str) -> None:
        raise NotImplementedError(NOT_PORTED.format("ALinkLoop.save"))

    def restore(self, path: str) -> bool:
        raise NotImplementedError(NOT_PORTED.format("ALinkLoop.restore"))

    def run(self, plain_raw: PersonStacks, dig_post: PersonStacks,
            checkpoint_path: str | None = None, heartbeat=None) -> ALinkState:
        """The loop over the unlabeled pool, slab by slab, until the pool
        ends or the oracle budget is spent (checked before each slab)."""
        if checkpoint_path:
            raise NotImplementedError(NOT_PORTED.format("loop_checkpoint"))
        if heartbeat is not None:
            raise NotImplementedError(NOT_PORTED.format("the heartbeat"))
        cfg = self.config
        p = dig_post.num_people
        while self.state.pool_cursor < p and not (
                self.state.un_size > 0
                and int(cfg.active_ratio * self.state.un_size)
                <= self.state.active_count):
            ii = self.state.pool_cursor
            sl = list(range(ii, min(ii + cfg.alink_bs, p)))
            self.run_iteration(plain_raw.take_people(sl),
                               dig_post.take_people(sl))
            self.state.pool_cursor = ii + cfg.alink_bs
        return self.state
