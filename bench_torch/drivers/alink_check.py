"""The check of what the A-LINK loop produced, for the slabs and finetunes
the driver captured in the window.

Per captured slab, on ``check_pairs`` of its pairs drawn from the seed:

- ``feature_gap``: the teacher features the chunk computed for the
  clean pairs against the reference teacher's, the worst relative L2
  distance of an image;
- ``m1_gap``: the committee's P(genuine) against the reference heads on
  those same features;
- ``student_gap``: the student's P(genuine) per noise channel on the
  noisy pairs the loop made, against the reference teacher and the
  student's weights as they were at that chunk;
- ``noise_gap``: the plain channels against the reference's draws from a
  copy of the loop's generator (pixel levels, all pairs of the slab);
- the one-pixel attack, replayed by the reference from the program's
  own draws and teacher-forced with its energies (``reference.de``):
  ``de_pixel_mismatch``, the pixels of the slab's attacked pairs that
  differ from the replay's; ``de_eval_mismatch``, the student answers
  (candidates scored and incumbents probed) that the program gave beyond
  or short of what the algorithm asks for, with any draw it lacks;
  ``de_fitness_gap``, on ``de_check_pairs`` pairs (half of them those
  that ran the most generations, the rest drawn from the seed), the
  widest gap between the program's energy ``1 - P(target)`` of every
  candidate and incumbent it scored and the reference teacher's and
  student's, with the student as it was at that chunk;
- ``selection_mismatch``: selected and queried counts of the slab's log
  against the reference selection on the program's probabilities.

Per captured finetune, ``m2_update_gap``: over M2's leaves, the gap
between the norms of the program's and the reference's parameter change,
as a share of the reference's norm of that leaf or of the median leaf,
whichever is larger.  The reference trains from the same start, on the
same queue, queried pairs (featurized by the reference teacher) and
replay batches, in the same order.  Leaves whose first gradient in the
reference is under a thousandth of the median leaf's are left out: they
move by round-off alone.

``substitute``: the control; the program's probabilities, the attack's
energies and M2's change are replaced by the reference's own in that
precision.
"""

from __future__ import annotations

import statistics

import torch

from bench_torch.reference import de as ref_de
from bench_torch.reference import head as ref_head
from bench_torch.reference import loop as ref_loop
from bench_torch.reference import resnet50 as ref_resnet

MODEL_CHANNELS = ("adversarial", "fgsm")


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check(driver, nx, substitute=None) -> dict:
    sys, t = driver.sys, driver.t
    cfg, w = sys.cfg, sys.weights
    stages = cfg["teacher"]["stage_sizes"]
    members = [w[k] for k in sorted(w) if k.startswith("head")
               and k != "head0"]
    names = list(t["noise"])

    def feats(x, numerics):
        return ref_resnet.features(w["teacher"], x, stages, numerics)

    def committee(fl, fr, numerics):
        return torch.stack([ref_head.genuine(m, fl, fr, numerics)
                            for m in members]).mean(0)

    if not driver.captured:
        raise RuntimeError("no slab was captured in the window")
    out = {"feature_gap": 0.0, "m1_gap": 0.0, "student_gap": 0.0,
           "noise_gap": 0.0, "selection_mismatch": 0.0}
    if "adversarial" in names:
        out.update(de_pixel_mismatch=0.0, de_eval_mismatch=0.0,
                   de_fitness_gap=0.0)
    for cap in driver.captured:
        pool = cap["pool"]
        left, right = pool[cap["left"]].float(), pool[cap["right"]].float()
        n = left.shape[0]
        gen = torch.Generator()
        gen.manual_seed(driver.seed * 1000 + cap["slab"])
        idx = torch.randperm(n, generator=gen)[:t["check_pairs"]].to(
            left.device)
        noisy_l, noisy_r = cap["noisy"]
        plain = [i for i, nm in enumerate(names) if nm not in MODEL_CHANNELS]
        if plain:
            g = torch.Generator(device=left.device)
            g.set_state(cap["gen"])
            rl, rr = ref_loop.noise_bank([names[i] for i in plain], g, left,
                                         right)
            out["noise_gap"] = max(out["noise_gap"], _gap(noisy_l[plain], rl),
                                   _gap(noisy_r[plain], rr))
            del rl, rr
        if "adversarial" in names:
            de = _attack_check(driver, cap, names.index("adversarial"), left,
                               right, feats, nx, substitute)
            out["de_pixel_mismatch"] += de["de_pixel_mismatch"]
            out["de_eval_mismatch"] += de["de_eval_mismatch"]
            out["de_fitness_gap"] = max(out["de_fitness_gap"],
                                        de["de_fitness_gap"])

        pl, pr = cap["feats"][0][idx], cap["feats"][1][idx]
        m1_prog = cap["m1"][idx]
        if substitute is not None:
            pl, pr = feats(left[idx], substitute), feats(right[idx],
                                                          substitute)
            m1_prog = committee(pl, pr, substitute)
        for prog, x in ((pl, left[idx]), (pr, right[idx])):
            ref = feats(x, nx)
            out["feature_gap"] = max(out["feature_gap"], float(
                (torch.linalg.vector_norm(prog.float() - ref, dim=1)
                 / torch.linalg.vector_norm(ref, dim=1)).max()))
        out["m1_gap"] = max(out["m1_gap"],
                            _gap(m1_prog, committee(pl, pr, nx)))
        for c in range(len(names)):
            nl, nr = noisy_l[c, idx], noisy_r[c, idx]
            ref = ref_head.genuine(cap["m2"], feats(nl, nx), feats(nr, nx),
                                   nx)
            prog = cap["probs"][c, idx]
            if substitute is not None:
                prog = ref_head.genuine(cap["m2"], feats(nl, substitute),
                                        feats(nr, substitute), substitute)
            out["student_gap"] = max(out["student_gap"], _gap(prog, ref))

        labels = torch.as_tensor(driver._pairs(cap["slab"])[3])
        sel, queried = ref_loop.select(cap["probs"].float().cpu(),
                                       cap["m1"].float().cpu(),
                                       labels.float(),
                                       cfg["loop"]["disparity_ratio"],
                                       cfg["loop"]["eps"])
        log = driver.logs[cap["slab"]]
        out["selection_mismatch"] += abs(sel - log.selected) + abs(
            int(queried.sum()) - log.queried)

    out["finetunes_checked"] = float(len(driver.finetunes))
    if driver.finetunes:
        out["m2_update_gap"] = max(_finetune_gap(driver, rec, feats, nx,
                                                 substitute)
                                   for rec in driver.finetunes)
    return out


def _attack_check(driver, cap, k, left, right, feats, nx,
                  substitute) -> dict:
    """The one-pixel attack of one captured chunk against its replay."""
    cfg = driver.sys.cfg
    noisy_l, noisy_r = cap["noisy"]
    h = left.shape[1]
    pairs = torch.cat([left, right], dim=1)
    target = torch.argmax(cap["m1_labels"], dim=-1)
    answers = (torch.cat(cap["de_answers"]) if cap["de_answers"]
               else pairs.new_zeros((0, 2)))
    rep = ref_de.replay(cap["de_draws"], answers, pairs, target,
                        pixel_count=cfg["de_pixel_count"],
                        popsize=cfg["de_popsize"], maxiter=cfg["de_maxiter"])
    prog = torch.cat([noisy_l[k], noisy_r[k]], dim=1)
    out = {"de_eval_mismatch": float(rep.rows_missing + rep.rows_extra
                                     + rep.draws_missing),
           "de_pixel_mismatch": float(
               prog.shape[0] * prog.shape[1] * prog.shape[2]
               if rep.images is None
               else (prog != rep.images).any(-1).sum()),
           "de_fitness_gap": 0.0}
    if rep.images is None:
        return out

    n = pairs.shape[0]
    gen = torch.Generator()
    gen.manual_seed(driver.seed * 1000 + cap["slab"] + 500)
    order = torch.randperm(n, generator=gen).tolist()
    take = min(driver.t["de_check_pairs"], n)
    nit = rep.nit.cpu().tolist()
    longest = sorted(order, key=lambda j: -nit[j])[:(take + 1) // 2]
    sample = set(longest + [j for j in order if j not in longest]
                 [:take - len(longest)])

    def energy(images, j, numerics):
        p = ref_head.genuine(cap["m2"], feats(images[:, :h], numerics),
                             feats(images[:, h:], numerics), numerics)
        probs = torch.stack([1.0 - p, p], dim=-1)
        return 1.0 - probs[:, int(target[j])]

    def compare(images, j, prog_e):
        if substitute is not None:
            prog_e = energy(images, j, substitute)
        out["de_fitness_gap"] = max(out["de_fitness_gap"],
                                    _gap(prog_e, energy(images, j, nx)))

    for live, xs, e in rep.scored:
        for pos, j in enumerate(live.tolist()):
            if j in sample:
                compare(ref_de.perturb(xs[pos][None], pairs[j][None])[0], j,
                        e[pos])
    for live, best, probs in rep.probed:
        for pos, j in enumerate(live.tolist()):
            if j in sample:
                compare(ref_de.perturb(best[pos][None, None],
                                       pairs[j][None])[0], j,
                        1.0 - probs[pos:pos + 1, int(target[j])])
    return out


def _finetune_gap(driver, rec, feats, nx, substitute) -> float:
    dev = driver.device
    lc = driver.sys.cfg["loop"]

    def data(numerics):
        bl, br, by = rec["buffer"]
        ls = [torch.as_tensor(bl, device=dev).float(),
              feats(rec["raw"][0], numerics)]
        rs = [torch.as_tensor(br, device=dev).float(),
              feats(rec["raw"][1], numerics)]
        ys = [torch.as_tensor(by), torch.as_tensor(rec["pseudo"])]
        for (rl, rr), ry in rec["replay"]:
            ls.append(torch.as_tensor(rl, device=dev).float())
            rs.append(torch.as_tensor(rr, device=dev).float())
            ys.append(torch.as_tensor(ry).reshape(-1))
        return (torch.cat(ls), torch.cat(rs),
                torch.cat([y.long() for y in ys]).to(dev))

    def train(numerics):
        l, r, y = data(numerics)
        return ref_loop.finetune(rec["before"], rec["opt"], l, r, y,
                                 epochs=lc["ft_epochs"],
                                 batch_size=lc["batch_size"],
                                 host_state=rec["host"], lr=rec["lr"],
                                 nx=numerics)

    ref_after, first = train(nx)
    prog_after = rec["after"]
    if substitute is not None:
        prog_after = train(substitute)[0]
    before = rec["before"]
    dr = {k: float((ref_after[k] - before[k]).norm()) for k in before}
    dp = {k: float((prog_after[k] - before[k]).norm()) for k in before}
    g_med = statistics.median(first.values())
    live = [k for k in before if first[k] >= 1e-3 * g_med]
    d_med = statistics.median(dr[k] for k in live)
    return max(abs(dp[k] - dr[k]) / max(dr[k], d_med) for k in live)
