"""Pair generation as index-space computation (counterpart of
``alink_tpu/data/pairs.py``).

A pair set is index arrays over person-padded stacks; pixels or features
move only in the final gather.  Every numpy draw is made in the JAX
package's order, so the same seed gives the same pair batches.

- ``balanced_pair_batches`` — infinite 1:1 genuine/imposter batch stream;
- ``all_pairs_index``       — plain x disguised + disguised x disguised grid
  over one flat image pool (``all_pairs_minibatch`` materialised);
- ``mtp_all_pairs_index``   — the Multi-PIE one-group grid over one flat
  pool (``mtp_all_pairs_minibatch`` materialised);
- ``split_disguise_data``   — per-person prefix/suffix split.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from alink_tpu_torch.data.loader import PersonStacks

PairIndex = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _grid_indices(counts_a: np.ndarray, counts_b: np.ndarray) -> PairIndex:
    """All (person_i image_x, person_j image_y) combos, label = (i == j)."""
    pl, xl, pr, yr, lab = [], [], [], [], []
    for i, ca in enumerate(counts_a):
        for j, cb in enumerate(counts_b):
            if ca == 0 or cb == 0:
                continue
            xs, ys = np.meshgrid(np.arange(ca), np.arange(cb), indexing="ij")
            n = xs.size
            pl.append(np.full(n, i))
            xl.append(xs.ravel())
            pr.append(np.full(n, j))
            yr.append(ys.ravel())
            lab.append(np.full(n, 1 if i == j else 0))
    if not pl:
        z = np.zeros(0, np.int32)
        return z, z, z, z, z
    cat = lambda parts: np.concatenate(parts).astype(np.int32)  # noqa: E731
    return cat(pl), cat(xl), cat(pr), cat(yr), cat(lab)


def gather_pairs(stacks_a: PersonStacks, stacks_b: PersonStacks,
                 idx: PairIndex) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialise (left, right, labels) from index arrays."""
    pl, xl, pr, yr, lab = idx
    return stacks_a.images[pl, xl], stacks_b.images[pr, yr], lab


def all_pairs_minibatch(plain: PersonStacks, dig: PersonStacks
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``createMiniBatch`` parity (readDFW.py:222-244): the plain x dig grid
    followed by the dig x dig grid, in reference enumeration order."""
    l1, r1, y1 = gather_pairs(plain, dig,
                              _grid_indices(plain.counts, dig.counts))
    l2, r2, y2 = gather_pairs(dig, dig, _grid_indices(dig.counts, dig.counts))
    return (np.concatenate([l1, l2]), np.concatenate([r1, r2]),
            np.concatenate([y1, y2]))


def mtp_all_pairs_minibatch(stacks: PersonStacks
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``readMTP.createMiniBatch`` (readMTP.py:123-135): one-group grid."""
    return gather_pairs(stacks, stacks,
                        _grid_indices(stacks.counts, stacks.counts))


def _sample_within(rng, counts, n):
    """n (person, image, image) draws from one group, images i.i.d."""
    live = np.flatnonzero(counts > 0)
    p = rng.choice(live, n)
    x = (rng.random(n) * counts[p]).astype(np.int64)
    y = (rng.random(n) * counts[p]).astype(np.int64)
    return p, x, y


def _sample_across(rng, counts_a, counts_b, n, same_group):
    """n cross-person draws; ``same_group`` forbids i == j."""
    live_a = np.flatnonzero(counts_a > 0)
    live_b = np.flatnonzero(counts_b > 0)
    if same_group and len(live_a) == 1 and len(live_b) == 1 \
            and live_a[0] == live_b[0]:
        # Only one live person: every "cross-person" draw would pair the
        # person with themselves yet be labeled imposter — silent
        # training corruption.  Surface the degenerate dataset instead.
        raise ValueError(
            "cannot draw imposter pairs: only one person has images")
    pa = rng.choice(live_a, n)
    pb = rng.choice(live_b, n)
    if same_group and len(live_a) > 1:
        clash = pa == pb
        while clash.any():
            pb[clash] = rng.choice(live_b, int(clash.sum()))
            clash = pa == pb
    xa = (rng.random(n) * counts_a[pa]).astype(np.int64)
    xb = (rng.random(n) * counts_b[pb]).astype(np.int64)
    return pa, xa, pb, xb


def balanced_pair_batches(
    seed: int,
    normal: PersonStacks,
    imp: PersonStacks | None,
    batch_size: int,
) -> Iterator[tuple[tuple[np.ndarray, np.ndarray], np.ndarray]]:
    """Infinite 1:1-balanced pair batch stream (readDFW.py:180-209).

    Yields ``((left, right), labels)`` with exactly ``batch_size // 2``
    genuine and imposter pairs each — an ODD batch_size therefore yields
    ``batch_size - 1`` pairs per batch.  Streams mirror the reference's
    ALINK.py:115-118: genuine from within-person draws of ``normal`` and
    (when given) within-folder draws of ``imp``; imposter from cross-person
    ``normal`` pairs, cross-folder ``imp`` pairs, and ``normal x imp``.
    """
    if batch_size < 2:
        raise ValueError(
            f"balanced_pair_batches needs batch_size >= 2 (one genuine + "
            f"one imposter pair); got {batch_size}")
    rng = np.random.default_rng(seed)
    half = batch_size // 2
    use_imp = imp is not None and int(np.sum(imp.counts > 0)) > 0

    while True:
        lefts, rights, labels = [], [], []
        # --- genuine half ---
        n_imp_pos = rng.binomial(half, 0.5) if use_imp else 0
        for src, n in ((normal, half - n_imp_pos), (imp, n_imp_pos)):
            if n == 0:
                continue
            p, x, y = _sample_within(rng, src.counts, n)
            lefts.append(src.images[p, x])
            rights.append(src.images[p, y])
            labels.append(np.ones(n, np.int32))
        # --- imposter half ---
        kinds = list(rng.integers(0, 3, half)) if use_imp else [0] * half
        counts_kind = [kinds.count(k) for k in range(3)]
        specs = [
            (normal, normal, True),
            (imp, imp, True) if use_imp else None,
            (normal, imp, False) if use_imp else None,
        ]
        for k, spec in enumerate(specs):
            n = counts_kind[k]
            if n == 0 or spec is None:
                continue
            a, b, same = spec
            pa, xa, pb, xb = _sample_across(rng, a.counts, b.counts, n, same)
            lefts.append(a.images[pa, xa])
            rights.append(b.images[pb, xb])
            labels.append(np.zeros(n, np.int32))
        left = np.concatenate(lefts)
        right = np.concatenate(rights)
        y = np.concatenate(labels)
        perm = rng.permutation(len(y))
        yield (left[perm], right[perm]), y[perm]


def all_pairs_index(
    plain: PersonStacks, dig: PersonStacks
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``createMiniBatch`` as pure index computation over a single flat
    image pool (readDFW.py:222-244 without materialising any pair).

    Returns ``(flat_images, left_idx, right_idx, labels)``: the
    concatenated (plain then disguised) image pool of shape
    (P_a*S_a + P_b*S_b, ...) and flat gather indices per pair.  Pixels are
    duplicated only at gather time — on device — so a pair batch uploads
    each image once instead of once per pair.
    """
    sa = plain.max_stack
    sb = dig.max_stack
    off = plain.num_people * sa
    flat = np.concatenate([
        plain.images.reshape((-1,) + plain.images.shape[2:]),
        dig.images.reshape((-1,) + dig.images.shape[2:]),
    ])
    g1 = _grid_indices(plain.counts, dig.counts)
    g2 = _grid_indices(dig.counts, dig.counts)
    li = np.concatenate([g1[0] * sa + g1[1], off + g2[0] * sb + g2[1]])
    ri = np.concatenate([off + g1[2] * sb + g1[3],
                         off + g2[2] * sb + g2[3]])
    y = np.concatenate([g1[4], g2[4]])
    return flat, li.astype(np.int32), ri.astype(np.int32), y


def mtp_all_pairs_index(stacks: PersonStacks
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """``readMTP.createMiniBatch`` as index computation (one group):
    ``(flat_images, left_idx, right_idx, labels)``."""
    s = stacks.max_stack
    flat = stacks.images.reshape((-1,) + stacks.images.shape[2:])
    g = _grid_indices(stacks.counts, stacks.counts)
    li = (g[0] * s + g[1]).astype(np.int32)
    ri = (g[2] * s + g[3]).astype(np.int32)
    return flat, li, ri, g[4]


def split_disguise_data(
    stacks: PersonStacks, pre_ratio: float = 0.5
) -> tuple[PersonStacks, PersonStacks]:
    """Per-person prefix/suffix split (splitDisguiseData, readDFW.py:212-219).

    Person ``p``'s first ``int(count * pre_ratio)`` images go to the pre
    split; the rest to post.  Both outputs keep the padded layout.
    """
    counts = stacks.counts
    pre_counts = (counts * pre_ratio).astype(np.int32)
    post_counts = counts - pre_counts
    s = stacks.max_stack
    pre_mask = np.arange(s)[None, :] < pre_counts[:, None]
    pre = np.where(
        pre_mask.reshape(pre_mask.shape + (1,) * (stacks.images.ndim - 2)),
        stacks.images,
        0.0,
    )
    # post: shift each person's tail left by pre_counts[p].
    idx = (np.arange(s)[None, :] + pre_counts[:, None]) % s
    post = np.take_along_axis(
        stacks.images,
        idx.reshape(idx.shape + (1,) * (stacks.images.ndim - 2)),
        axis=1,
    )
    post_mask = np.arange(s)[None, :] < post_counts[:, None]
    post = np.where(
        post_mask.reshape(post_mask.shape + (1,) * (stacks.images.ndim - 2)),
        post,
        0.0,
    )
    return (
        PersonStacks(pre.astype(stacks.images.dtype), pre_counts),
        PersonStacks(post.astype(stacks.images.dtype), post_counts),
    )
