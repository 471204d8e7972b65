"""The comparisons that decide ``correct``, each number beside its limit.

A cell's ``portbench/checks/<workload>.json`` holds its limits and the
readings they were set from.  The numbers:

* ``served_gap`` (serving): over a sample of sessions drawn from the
  seed, the longest among them, every token the engine served: the
  widest gap by which its logit lies below the best logit of the plain
  float32 reference run over the same tokens;
* ``charge_mismatch_steps`` (serving): steps whose in-step charge
  decided otherwise than the plain reference decides from the table the
  step read (grants, stalls and the columns it writes);
* ``table_mismatch_domains`` (serving): domains whose usage at the
  window's close differs from the pages the sessions' lengths hold;
* ``pool_overshoot_pages`` (serving): the most the root's usage after
  any charge in the window lay above the pool;
* ``off_positions_share`` (prefill): over prompts drawn from the seed
  among those the window completed, at positions drawn from the seed
  (the last among them), the share (%) of positions whose logits differ
  from the reference's by more than ``position_tol`` of the reference's
  norm.  A share, not one norm over all positions: top-2 routing turns
  on near ties, and a position whose routing bfloat16 rounding flips
  lies far from the float32 reference although nothing is wrong, so a
  norm over all positions follows the few flipped ones; a fault or a
  lower precision moves most positions.  The norm over all positions
  (``logits_rel_err``) and the median position's error are kept beside
  it as readings.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import charge as charge_ref


def sample_sessions(logs: dict, seed: int, served_tokens: int,
                    max_sessions: int) -> list:
    """The sessions to check: the one that served most, then others in an
    order drawn from the seed, until ``served_tokens`` are covered."""
    have = sorted((lg for lg in logs.values() if lg.served),
                  key=lambda lg: (-len(lg.served), lg.sid))
    if not have:
        return []
    rest = have[1:]
    order = np.random.default_rng(seed).permutation(len(rest))
    out = [have[0]]
    for i in order:
        if sum(len(lg.served) for lg in out) >= served_tokens or \
                len(out) >= max_sessions:
            break
        out.append(rest[int(i)])
    return out


def session_inputs(logs: list, device) -> tuple:
    """Each sampled session's fed tokens up to its last served position,
    the served positions and the served tokens."""
    seqs, want, tok = [], [], []
    for lg in logs:
        last = max(p for p, _ in lg.served)
        seq = [lg.fed[p] for p in range(last + 1)]
        seqs.append(torch.tensor(seq, dtype=torch.int64, device=device))
        want.append(torch.tensor([p for p, _ in lg.served],
                                 dtype=torch.int64, device=device))
        tok.append(torch.tensor([t for _, t in lg.served],
                                dtype=torch.int64, device=device))
    return seqs, want, tok


def served_gap(ref_logits: list, tokens: list) -> float:
    """The widest gap between the reference's best logit and its logit
    of the served token, over every served token."""
    worst = 0.0
    for lg, tk in zip(ref_logits, tokens):
        gap = lg.max(-1).values - lg.gather(1, tk[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def first_choice_gap(ref_logits: list, other_logits: list) -> float:
    """The control's reading: the widest gap, in the reference, of the
    token that the other (lower-precision) logits put first."""
    return served_gap(ref_logits, [o.argmax(-1) for o in other_logits])


def charge_mismatches(calls: list, step_ms: float) -> tuple:
    """Steps whose charge differs from the plain reference's decision on
    the table it read; and the largest root usage after a charge."""
    bad, root = 0, 0
    for c in calls:
        want = charge_ref.charge(c["pre"], c["dom"], c["amt"], c["step"],
                                 step_ms)
        same = (np.array_equal(want["granted"], c["granted"])
                and np.array_equal(want["stalled"], c["stalled"]))
        for k in ("usage", "peak", "throttle_until", "mem_stall"):
            same = same and np.array_equal(want[k], c["post"][k])
        same = same and np.array_equal(want["prog"], c["post"]["prog"])
        bad += 0 if same else 1
        root = max(root, int(c["post"]["usage"][0]))
    return bad, root


def position_errors(got: list, want: list) -> torch.Tensor:
    """Each position's relative error: the norm of its logits' difference
    over the norm of the reference's logits there."""
    out = [((g.float() - w).norm(dim=-1) / w.norm(dim=-1).clamp(min=1e-30))
           for g, w in zip(got, want)]
    return torch.cat(out)


def off_share(errors: torch.Tensor, tol: float) -> float:
    return 100.0 * float((errors > tol).float().mean())


def rel_err(got: list, want: list) -> float:
    num = sum(float(((g.float() - w) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float((w ** 2).sum()) for w in want)
    return (num / max(den, 1e-30)) ** 0.5


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: each number beside its limit; a number
    above its limit, or missing, is not correct."""
    checks = {}
    ok = True
    for name, lim in limits.items():
        val = numbers.get(name)
        checks[name] = {"value": val, "limit": lim}
        if val is None or not val <= lim:
            ok = False
    return ok, checks
