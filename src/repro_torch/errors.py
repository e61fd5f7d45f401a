"""`repro_torch.errors`: the typed exception hierarchy of the port.

The same types as the reference package's, so a caller dispatches on the
kind of failure (``except BudgetError``) rather than on a message:

  * `PlanError`: planning failed (bad objective, unknown strategy, a
    malformed request). Subclasses `ValueError`, so ``except ValueError``
    call sites keep working.
  * `BudgetError`: the retryable planning failure, no feasible candidate
    under the current MAC, shared-memory or residency budget. The caller can
    re-plan under another budget (``NetPlan.replan``).
  * `DeadlineExceeded`: a request's deadline passed before service
    completed. Subclasses `TimeoutError`.
  * `Shed`: a bounded admission queue rejected the request outright.
  * `InvariantViolation`: a fault-injection invariant failed (word-count
    drift, a replan that differs from a fresh plan).

The port raises `PlanError` and `BudgetError` today; the other three wait
for the planner service and the fault harness (ROADMAP A10).
"""

from __future__ import annotations

__all__ = [
    "ReproError", "PlanError", "BudgetError", "DeadlineExceeded", "Shed",
    "InvariantViolation",
]


class ReproError(Exception):
    """Root of the typed exception hierarchy."""


class PlanError(ReproError, ValueError):
    """Planning failed: malformed request, unknown strategy/objective, or an
    internally inconsistent plan. A `ValueError` too."""


class BudgetError(PlanError):
    """No feasible schedule under the current MAC, shared-memory or
    residency budget: the caller can re-plan under another budget or shed
    the request; the search itself is not at fault."""


class DeadlineExceeded(ReproError, TimeoutError):
    """A request's deadline passed before (or during) service."""

    def __init__(self, message: str = "", *, lateness_s: float = 0.0):
        super().__init__(message or f"deadline exceeded by {lateness_s:.4f}s")
        self.lateness_s = lateness_s


class Shed(ReproError, RuntimeError):
    """Admission control rejected the request (bounded queue overflow)."""


class InvariantViolation(ReproError, AssertionError):
    """A fault-injection invariant failed: word-count drift under faults,
    replan/fresh-plan divergence, or an availability-floor breach."""
