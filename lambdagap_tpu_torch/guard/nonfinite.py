"""Training guardrails: a device-side finiteness flag with a policy.

The port of ``lambdagap_tpu/guard/nonfinite.py``. One non-finite gradient
(an exploding objective, a poisoned label, an overflowed hessian) corrupts
every later tree, so each round computes a device flag and applies the
``guard_nonfinite`` policy:

- ``raise`` (default): raise :class:`NonFiniteError`.
- ``skip_tree``: drop the round's trees and restore the scores (training
  and validation), the model count, the iteration and the shrinkage from
  before the round. Training goes on; the bad round contributes no tree.
- ``clip``: sanitize gradients and hessians on the device before any tree
  sees them (NaN -> 0, values clamped to +-``guard_clip``); no flag.
- ``off``: no checks.

Sync discipline: the flag is computed on the device when the gradients are
admitted, ``[isfinite(grad).all() & isfinite(hess).all(),
isfinite(scores).all()]``, with the scores as they enter the round. Its
host read rides the round's first record read in the tree learner
(``FusedTreeLearner.train_device``, the root step of the round's first
tree; ``SerialTreeLearner.train``, the root's read), so the guard adds no
sync point to a round. A fused round whose tree never reads
(``num_leaves=1``) reads the flag alone.

The JAX package checks the scores after the round's update. So does
``Booster.update`` (:meth:`TrainGuard.finish` before it returns, one host
read). ``engine.train`` checks them as the next round enters instead: the
finiteness of the scores a round leaves behind is read with the next
round's first record read (and once at the end of ``train``,
:meth:`TrainGuard.finish`). When the next round finds them non-finite, the
guard acts for the round that made them: ``raise`` before
the new round adds a tree, with the booster in the state the JAX package
raises from; ``skip_tree`` restores the state from before that round and
the random streams from after it (as the JAX package leaves them), and the
round is grown again. The JAX package's JSONL diagnostic event is a single
warning line here; its fault injection (``guard_faults``) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..utils import log

POLICIES = ("off", "raise", "skip_tree", "clip")


class NonFiniteError(FloatingPointError):
    """Raised under ``guard_nonfinite=raise`` when grad/hess/scores go
    non-finite."""


def sanitize(x: torch.Tensor, clip: float) -> torch.Tensor:
    """NaN -> 0, +-Inf -> +-clip, values beyond +-clip clamped."""
    return torch.clamp(torch.where(torch.isnan(x), torch.zeros_like(x), x),
                       -clip, clip)


class TrainGuard:
    """Per-booster guardrail state; inert when ``policy == 'off'``.

    Inside ``GBDT.train_one_iter``: :meth:`begin_iteration` (the restore
    point, ``skip_tree`` only), :meth:`admit_gradients` (clip, or the flag
    handed to the learner), :meth:`after_first_tree` (the late score check
    of the previous round) and :meth:`end_iteration` (this round's
    gradient check; True when the round was skipped)."""

    def __init__(self, policy: str = "raise", clip: float = 1e30) -> None:
        if policy not in POLICIES:
            log.fatal("unknown guard_nonfinite policy %r (choose from %s)",
                      policy, "/".join(POLICIES))
        self.policy = policy
        self.clip = float(clip)
        self._flag: Optional[torch.Tensor] = None
        self._read = None
        self._cur: Optional[Dict[str, Any]] = None
        self._prev: Optional[Dict[str, Any]] = None
        # a round updated the scores and nothing has read them since
        self._unchecked = False
        # this round's restore point is taken (DART takes it before its
        # dropout, and the base round's call is then a no-op)
        self._captured = False

    @classmethod
    def from_config(cls, config) -> "TrainGuard":
        return cls(policy=config.guard_nonfinite, clip=config.guard_clip)

    @property
    def checks(self) -> bool:
        return self.policy in ("raise", "skip_tree")

    # ------------------------------------------------------------------
    def begin_iteration(self, gbdt) -> None:
        if self.policy == "skip_tree" and not self._captured:
            self._prev, self._cur = self._cur, gbdt._guard_state_capture()
            self._captured = True

    def admit_gradients(self, gbdt, grad, hess):
        if self.policy == "clip":
            return sanitize(grad, self.clip), sanitize(hess, self.clip)
        if self.checks:
            self._flag = torch.stack([
                torch.isfinite(grad).all() & torch.isfinite(hess).all(),
                torch.isfinite(gbdt.scores).all()])
            self._read = None
            gbdt.learner.guard_flag = self._flag
        return grad, hess

    def _flags(self, gbdt):
        """(gradients finite, entering scores finite), from the learner's
        first record read of the round, or read here when it made none."""
        if self._read is None:
            lr = gbdt.learner
            got, lr.guard_flag, lr.guard_read = lr.guard_read, None, None
            self._read = (got if got is not None
                          else [bool(v) for v in self._flag.tolist()])
        return self._read

    def after_first_tree(self, gbdt) -> bool:
        """After the round's first tree (its read done): True when the
        scores the previous round left are non-finite. Under ``raise``
        this raises; under ``skip_tree`` the state from before that round
        is restored and the caller grows the round again."""
        if not self.checks:
            return False
        ok_grad, ok_scores = self._flags(gbdt)
        late = self._unchecked and not ok_scores
        self._unchecked = False
        if not late:
            return False
        it = gbdt.iter_ - 1
        self._report(gbdt, it)
        if self.policy == "raise":
            raise NonFiniteError(
                f"non-finite scores after iteration {it} "
                "(guard_nonfinite=raise)")
        if self._prev is None:
            return False
        rng = self._cur["rng"]
        gbdt._guard_state_restore(self._prev, rng)
        self._cur = self._prev = None
        self._captured = False
        log.warning("guard: non-finite scores after iteration %d — its "
                    "trees dropped, scores restored "
                    "(guard_nonfinite=skip_tree)", it)
        return True

    def end_iteration(self, gbdt) -> bool:
        """This round's check; True when the round was skipped (its state
        already restored)."""
        if not self.checks:
            return False
        ok_grad, ok_scores = self._flags(gbdt)
        self._flag = self._read = None
        self._unchecked = True
        self._captured = False
        if ok_grad and ok_scores:
            return False
        it = gbdt.iter_ - 1
        self._report(gbdt, it)
        if self.policy == "raise":
            raise NonFiniteError(
                f"non-finite gradients/hessians/scores at iteration {it} "
                "(guard_nonfinite=raise)")
        gbdt._guard_state_restore(self._cur)
        self._unchecked = False
        log.warning("guard: non-finite gradients at iteration %d — tree "
                    "dropped, scores restored (guard_nonfinite=skip_tree)",
                    it)
        return True

    def finish(self, gbdt) -> bool:
        """The last round's scores, read by ``Booster.update`` after its
        round and by ``engine.train`` once when training ends. True when
        that round was dropped."""
        if not (self.checks and self._unchecked):
            return False
        self._unchecked = False
        if bool(torch.isfinite(gbdt.scores).all()):
            return False
        it = gbdt.iter_ - 1
        self._report(gbdt, it)
        if self.policy == "raise":
            raise NonFiniteError(
                f"non-finite scores after iteration {it} "
                "(guard_nonfinite=raise)")
        gbdt._guard_state_restore(self._cur)
        log.warning("guard: non-finite scores after iteration %d — its "
                    "trees dropped, scores restored "
                    "(guard_nonfinite=skip_tree)", it)
        return True

    def _report(self, gbdt, it: int) -> None:
        log.warning('guard diagnostic: {"type":"event","event":'
                    '"guard_nonfinite","policy":"%s","iter":%d,'
                    '"num_trees":%d}', self.policy, it, len(gbdt.models))
