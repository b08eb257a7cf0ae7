"""The A-LINK loop (counterpart of ``alink_tpu/active/loop.py``; the
reference's ALINK.py:145-259).  Per slab of ``alink_bs`` unlabeled persons:

1. build the all-pairs slab with ``pair_builder`` (DFW: plain x disguised +
   disguised x disguised; Multi-PIE: one group, ``mtp_all_pairs_index``);
   its ground-truth labels act as the pseudo-oracle;
2. in chunks of at most ``device_batch`` pairs: gather the pairs from the
   device-resident pool, featurize, committee (M1) probabilities and
   one-hot labels, the noise bank on the raw pixels resized to
   ``student_res`` (its model channels attack the live student toward M1's
   labels; grad is enabled only inside FGSM), student (M2) probabilities
   per channel;
3. disparity selection, all-noise intersection and the oracle gate
   (``active.selection``, with the host-exact take count ``int(n * ratio)``);
4. queue equal per-noise shares of the queried pairs;
5. once the queue holds ``batch_send`` pairs: add the clean queried pairs
   (with ``augment``, their rotated, sheared and shifted copies: kernel K2,
   ``ops.augment``) and ``mixture_ratio`` replay batches, finetune M2 with
   ``fit`` (batch 16; a student with dropout draws its masks from the
   loop's device generator), flush;
6. stop once ACTIVE_COUNT >= active_ratio * UN_SIZE (tested before each
   slab).

The loop state (M2 module and optimizer, counters, queue, the device and
host generator states, the replay position) is checkpointable: ``save``,
``restore`` and ``run(checkpoint_path=)`` resume a run exactly where it was
interrupted (the reference loses it all, SURVEY.md section 5.4).  On the
card that holds only while every op of a chunk and of the finetune is
deterministic from run to run: the hand-written kernels are,
``cudnn.benchmark`` stays off, and the noise bank's one scatter-add
(``poisson``'s level counts) sums integers, exact in any order.

The student's inputs: with ``student_featurize="same"`` (the DFW drivers)
M2 is a ``SiameseHead`` over the teacher's features; with a callable or
None and ``student_is_head=False`` (the Multi-PIE driver) M2 is an image
model, SmallRes, over ``student_featurize``'d (None: raw) pixels at
``student_res``, scored with its logits and a softmax, and the queue holds
those image-shaped inputs.

PyTorch runs eagerly, so the JAX package's shape bucketing (pool rows,
chunk widths, gathers), which exists to bound recompiles, is not ported:
chunks take their real width.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from alink_tpu_torch.active.committee import Committee
from alink_tpu_torch.active.selection import select_queries
from alink_tpu_torch.data.loader import PersonStacks
from alink_tpu_torch.data.pairs import all_pairs_index
from alink_tpu_torch.ops.augment import augment_pairs
from alink_tpu_torch.ops.image import resize
from alink_tpu_torch.ops.pairwise import pair_scores
from alink_tpu_torch.train.checkpoint import maybe_restore
from alink_tpu_torch.train.checkpoint import save as ckpt_save
from alink_tpu_torch.train.trainer import TrainState, fit
from alink_tpu_torch.utils.debug import check_finite
from alink_tpu_torch.utils.profiling import Timings

# device_batch="auto": the JAX package probes the host-device round trip
# and picks 64 below 2 ms (alink_tpu/utils/dispatch.py:29-30,54-63); every
# device the port runs on, CUDA or CPU, is attached locally, so "auto" is 64.
AUTO_DEVICE_BATCH = 64


@dataclasses.dataclass
class ALinkState:
    """Loop state: the student, the oracle accounting, the queue, and the
    loop's records (one ``IterationLog`` per slab, per-phase ``timings``)."""

    m2_state: TrainState
    active_count: int = 0
    un_size: int = 0
    pool_cursor: int = 0  # person index into the unlabeled pool
    replay_draws: int = 0  # batches consumed from replay_gen (for resume)
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
        featurize: ``(N, H, W, C) f32 tensor -> (N, D)`` on ``device``, M1's
            featurizer.
        committee: the M1 ensemble over feature pairs.
        m2_state: the student's ``TrainState`` (a ``SiameseHead``, or with
            ``student_is_head=False`` an image model such as SmallRes).
        student_featurize: the student's input map on the noisy, clean or
            augmented images at ``student_res``: ``"same"`` (default) is
            ``featurize`` (M1 and M2 share the backbone, ALINK.py:167), a
            callable maps them (Multi-PIE: ``preprocess.smallres``), None
            feeds the raw pixels.
        student_is_head: M2 scores features with the siamese head's
            ``pair_scores`` (True) or images with its own logits and a
            softmax (False).
        student_res: ``(h, w)`` the noisy pairs are resized to for the
            student; default ``config.image_res`` (cv2's (w, h)) flipped.
        pair_builder: ``(plain part, dig part) -> (pool, left_idx,
            right_idx, labels)`` of a slab (default ``all_pairs_index``).
        replay_gen: iterator of clean ``((left, right), y)`` batches in the
            student's input space, mixed into each finetune.
        device_batch: pairs per chunk (default ``config.device_batch``;
            ``"auto"`` is ``AUTO_DEVICE_BATCH``).
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
        metrics: an optional ``utils.metrics.MetricsLogger``; each slab logs
            an ``alink_iteration`` event with the ``IterationLog`` fields.

    ``config.debug_nans`` guards the selection probabilities and the
    finetuned M2 parameters (``utils.debug.check_finite``).
    """

    def __init__(self, config, *, featurize: Callable, committee: Committee,
                 m2_state: TrainState,
                 student_featurize: Callable | str | None = "same",
                 student_is_head: bool = True,
                 student_res: tuple[int, int] | None = None,
                 pair_builder: Callable = all_pairs_index,
                 replay_gen: Iterator | None = None,
                 device_batch: int | None = None, pool_uint8: bool = False,
                 generator: torch.Generator | None = None,
                 host_generator: torch.Generator | None = None,
                 adversarial_predict: Callable | None = None,
                 adversarial_kwargs: dict | None = None,
                 device=None, metrics=None):
        db = device_batch if device_batch is not None else getattr(
            config, "device_batch", 1024)
        if isinstance(db, str):
            if db != "auto":
                raise ValueError(f"device_batch must be a positive int or "
                                 f"'auto', got {db!r}")
            db = AUTO_DEVICE_BATCH
        if int(db) <= 0:
            raise ValueError(f"device_batch must be positive, got {db!r}")
        self.config = config
        self.device_batch = int(db)
        self.metrics = metrics
        self._nan_guard = bool(getattr(config, "debug_nans", False))
        self.featurize = featurize
        self.committee = committee
        self.adversarial_predict = adversarial_predict
        self.adversarial_kwargs = adversarial_kwargs
        self.student_featurize = (featurize if student_featurize == "same"
                                  else student_featurize)
        self.student_is_head = student_is_head
        # The noisy pairs are resized to the student's (h, w); the config
        # holds cv2's (w, h).
        self.student_res = (tuple(student_res) if student_res is not None
                            else (config.image_res[1], config.image_res[0]))
        self.pair_builder = pair_builder
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
        self._replay_consumed = 0  # batches served by replay_gen (resume)
        # Iterations completed before the last restore(): resumed
        # IterationLog.iteration indices continue the interrupted run's
        # metrics stream instead of colliding with its records at 0..N.
        self._iteration_offset = 0

    @property
    def logs(self) -> list[IterationLog]:
        return self.state.logs

    @property
    def timings(self) -> Timings:
        return self.state.timings

    # -- helpers ---------------------------------------------------------

    def _features(self, images: torch.Tensor,
                  featurize: Callable | None = None) -> torch.Tensor:
        """``featurize`` (default M1's) in pieces of at most
        ``device_batch`` images."""
        fn = featurize if featurize is not None else self.featurize
        db = self.device_batch
        return torch.cat([fn(images[i:i + db])
                          for i in range(0, images.shape[0], db)])

    def _student_inputs(self, images: torch.Tensor) -> torch.Tensor:
        """Images at ``student_res`` -> the student's input space."""
        if self.student_featurize is None:
            return images
        return self._features(images, self.student_featurize)

    def _student_probs(self, left: torch.Tensor,
                       right: torch.Tensor) -> torch.Tensor:
        """M2's P(genuine) per pair (disguisedFacesModel.predict[:, 1])."""
        m2 = self.state.m2_state
        if self.student_is_head:
            return pair_scores(m2.module, left, right)
        return torch.softmax(m2.logits(left, right), dim=-1)[:, 1]

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
        sli = self._student_inputs(noisy_l.reshape((-1,) + noisy_l.shape[2:]))
        sri = self._student_inputs(noisy_r.reshape((-1,) + noisy_r.shape[2:]))
        probs = self._student_probs(sli, sri)
        return (m1[:, 1], probs.reshape(k, nc),
                sli.reshape((k, nc) + sli.shape[1:]),
                sri.reshape((k, nc) + sri.shape[1:]))

    # -- one slab --------------------------------------------------------

    def run_iteration(self, plain_part: PersonStacks,
                      dig_part: PersonStacks) -> IterationLog:
        cfg = self.config
        dev = self.device
        with self.timings.phase("pairs"):
            flat, left_idx, right_idx, y = self.pair_builder(plain_part,
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
        if self._nan_guard:
            # Catch a diverged committee or student or a degenerate noise
            # channel here, before its probabilities drive selection.
            check_finite((m1_genuine, student_probs),
                         "selection probabilities", force=True)
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

        log = IterationLog(iteration=self._iteration_offset + len(self.logs),
                           pairs=n, selected=selected_count,
                           queried=int(queried.size),
                           active_count=self.state.active_count,
                           un_size=self.state.un_size, finetuned=finetuned)
        self.logs.append(log)
        if self.metrics is not None:
            self.metrics.log("alink_iteration", **log._asdict())
        return log

    def _finetune(self, left_raw, right_raw, pseudo):
        """Queue + clean (or augmented) queried pairs + replay, then ``fit``
        M2 (batch 16, ALINK.py:251) and flush the queue."""
        cfg = self.config
        parts_l = [self.state.buffer_left]
        parts_r = [self.state.buffer_right]
        parts_y = [self.state.buffer_y]
        labels = np.asarray(pseudo)
        if cfg.augment:
            # Augment the raw queried pairs, then map them into student
            # space (ALINK.py:241-245 augments pixels and re-featurizes).
            # augment_pairs emits variant blocks [original, rotation, shear,
            # shift] of q rows each; the port does not pad, so every row of
            # every block is real and trains.
            left_raw, right_raw, y = augment_pairs(
                self.generator, left_raw, right_raw,
                torch.as_tensor(labels, device=left_raw.device))
            labels = y.cpu().numpy()
        with torch.no_grad():
            parts_l.append(self._student_inputs(
                resize(left_raw, self.student_res)).cpu().numpy())
            parts_r.append(self._student_inputs(
                resize(right_raw, self.student_res)).cpu().numpy())
        parts_y.append(labels)
        if self.replay_gen is not None:
            for _ in range(cfg.mixture_ratio):
                (rl, rr), ry = next(self.replay_gen)
                self.state.replay_draws += 1
                self._replay_consumed += 1
                parts_l.append(np.asarray(rl))
                parts_r.append(np.asarray(rr))
                parts_y.append(np.asarray(ry).reshape(-1))
        self.state.m2_state, _ = fit(
            self.state.m2_state, np.concatenate(parts_l),
            np.concatenate(parts_r),
            np.concatenate(parts_y).astype(np.int64), epochs=cfg.ft_epochs,
            batch_size=16, generator=self.host_generator,
            dropout_generator=self.generator)
        if self._nan_guard:
            # A diverged finetune silently poisons every later round: fail
            # at the step that produced it.
            check_finite(self.state.m2_state.module, "finetuned M2 params",
                         force=True)
        self.state.flush_buffer()

    # -- checkpoint / resume (SURVEY.md section 5.4) -----------------------

    def save(self, path: str) -> None:
        """Checkpoint the loop state, in the JAX package's layout:

        - ``<path>/m2``: the student's state dict, its optimizer's state dict
          (the Adadelta accumulators and the live learning rate that
          ReduceLROnPlateau moves) and its step count;
        - ``<path>/loop``: the counters ``[active_count, un_size,
          pool_cursor, replay_draws, completed iterations]`` (int64), the
          device and host generator states (CPU byte tensors from
          ``Generator.get_state()``, a CUDA generator's too) and the queue
          when it is not empty.
        """
        s = self.state
        m2 = s.m2_state
        done = self._iteration_offset + len(self.logs)
        with self.timings.phase("save"):
            # Both files carry the completed-iterations count: a save cut
            # between the two writes leaves files that disagree on it, and
            # restore() refuses them instead of pairing slab k+1's M2 with
            # slab k's counters, generators and queue.
            ckpt_save(os.path.join(path, "m2"),
                      {"module": m2.module.state_dict(),
                       "optimizer": m2.optimizer.state_dict(),
                       "step": torch.tensor(m2.step, dtype=torch.int64),
                       "completed": torch.tensor(done, dtype=torch.int64)})
            loop_tree = {
                "counters": np.array(
                    [s.active_count, s.un_size, s.pool_cursor,
                     s.replay_draws, done], np.int64),
                # Restoring both generators makes a resumed run reproduce
                # the uninterrupted trajectory: noise and augment draws come
                # from the device one, finetune shuffles from the host one.
                "generator": self.generator.get_state(),
                "host_generator": self.host_generator.get_state(),
            }
            if s.buffer_size():
                loop_tree.update(buffer_left=s.buffer_left,
                                 buffer_right=s.buffer_right,
                                 buffer_y=np.asarray(s.buffer_y, np.int64))
            ckpt_save(os.path.join(path, "loop"), loop_tree)

    def restore(self, path: str) -> bool:
        """Resume from a ``save`` checkpoint; False (and nothing changed) if
        there is none at ``path``, or if its two files come from different
        saves (a save cut between its writes)."""
        with self.timings.phase("restore"):
            m2_tree, ok = maybe_restore(os.path.join(path, "m2"))
            loop_tree, ok2 = maybe_restore(os.path.join(path, "loop"))
            if not (ok and ok2):
                return False
            stamps = (int(m2_tree["completed"]),
                      int(np.asarray(loop_tree["counters"]).reshape(-1)[4]))
            if stamps[0] != stamps[1]:
                print(f"[alink] ignoring the torn checkpoint at {path}: "
                      f"m2 after {stamps[0]} iterations, loop after "
                      f"{stamps[1]}")
                return False
            m2 = self.state.m2_state
            m2.module.load_state_dict(m2_tree["module"])
            m2.optimizer.load_state_dict(m2_tree["optimizer"])
            m2.step = int(m2_tree["step"])
            self.generator.set_state(loop_tree["generator"])
            self.host_generator.set_state(loop_tree["host_generator"])
            self.load_counters(loop_tree["counters"])
            self.load_queue(loop_tree)
        return True

    def load_counters(self, counters) -> None:
        """Set ``[active_count, un_size, pool_cursor, replay_draws,
        completed iterations]`` and fast-forward the replay generator."""
        s = self.state
        (s.active_count, s.un_size, s.pool_cursor, s.replay_draws,
         done) = (int(v) for v in np.asarray(counters).reshape(-1))
        # The next IterationLog is numbered ``done``, even if this loop
        # already has in-process logs from a divergent path.
        self._iteration_offset = done - len(self.logs)
        if self.replay_gen is not None:
            # Skip only the delta from what this generator has already
            # served, so a second restore() (or restore() followed by
            # run(checkpoint_path=...)) skips nothing twice.
            while self._replay_consumed < s.replay_draws:
                next(self.replay_gen)
                self._replay_consumed += 1

    def load_queue(self, tree) -> None:
        """Set the queue from ``buffer_left``/``_right``/``_y`` of ``tree``,
        or flush it when the tree holds none."""
        s = self.state
        if "buffer_y" not in tree:
            s.flush_buffer()
            return
        s.buffer_left, s.buffer_right, s.buffer_y = (
            np.asarray(tree[k]) for k in ("buffer_left", "buffer_right",
                                          "buffer_y"))

    # -- full run --------------------------------------------------------

    def run(self, plain_raw: PersonStacks, dig_post: PersonStacks,
            checkpoint_path: str | None = None, checkpoint_every: int = 1,
            heartbeat=None, heartbeat_timeout_s: float = 600.0
            ) -> ALinkState:
        """The loop over the unlabeled pool, slab by slab, until the pool
        ends or the oracle budget is spent (ALINK.py:145-259).

        ``checkpoint_path``: resume from it when a checkpoint is there, save
        every ``checkpoint_every`` slabs and once at the end.  A resumed run
        reproduces the uninterrupted one exactly.

        ``heartbeat`` (a ``utils.resilience.Heartbeat``): before each slab,
        beat this process's beacon and raise ``PeerFailure`` if a peer has
        missed ``heartbeat_timeout_s``, surfacing a dead host to the
        supervisor instead of blocking in the next collective.
        """
        cfg = self.config
        if checkpoint_path:
            resumed = self.restore(checkpoint_path)
            print(f"[alink] {'resumed from' if resumed else 'no checkpoint at'}"
                  f" {checkpoint_path}")
        p = dig_post.num_people
        iters = 0
        # The stop test comes BEFORE each slab: a resumed run whose restored
        # state already satisfies it must not run (and charge the oracle
        # for) another slab.
        while self.state.pool_cursor < p and not (
                self.state.un_size > 0
                and int(cfg.active_ratio * self.state.un_size)
                <= self.state.active_count):
            ii = self.state.pool_cursor
            sl = list(range(ii, min(ii + cfg.alink_bs, p)))
            if heartbeat is not None:
                heartbeat.beat()
                heartbeat.ensure_peers_alive(heartbeat_timeout_s)
            self.run_iteration(plain_raw.take_people(sl),
                               dig_post.take_people(sl))
            self.state.pool_cursor = ii + cfg.alink_bs
            iters += 1
            if checkpoint_path and iters % max(1, checkpoint_every) == 0:
                self.save(checkpoint_path)
        if checkpoint_path:
            self.save(checkpoint_path)
        return self.state
