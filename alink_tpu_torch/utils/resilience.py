"""Failure detection and retry/elastic recovery (counterpart of
``alink_tpu/utils/resilience.py``; SURVEY.md section 5.3).

The reference has no failure story at all: an interrupted ``ALINK.py`` run
loses every selection decision and oracle charge (``code/ALINK.py:135-143``
rebuilds state from scratch), and a crashed host in a multi-GPU run would
hang the rest forever.  A ``torch.distributed`` job fails as the JAX
multi-host runtime does: when one process dies, the others' next
collective blocks until their own runtime notices; there is no in-band
elasticity, recovery is restart-and-resume.  Three layers:

1. **Exact resume**: ``ALinkLoop.run(checkpoint_path=)`` checkpoints the
   generator states, pool cursor, replay position and queue, so a
   restarted process reproduces the uninterrupted trajectory bit for bit.
2. **In-process retry** (this module): ``run_with_retries`` supervises a
   resumable step function, classifies failures as retryable (CUDA
   faults, preemption-shaped RuntimeErrors, transient IO) or fatal
   (programming errors), backs off, and re-invokes; the step resumes from
   its checkpoint.  This is the single-host analog of a cluster
   launcher's restart policy.
3. **Peer failure detection** (this module): ``Heartbeat`` /
   ``check_peers``, a shared-filesystem heartbeat protocol (the storage
   the checkpoints already use) that lets any process detect a dead peer
   *without* entering a collective that would block forever, and
   ``barrier`` with a timeout for coordinated restart decisions.  On
   detection the surviving processes raise ``PeerFailure`` so the outer
   launcher can restart the job; resume is then layer 1's job.

Nothing here needs real multi-host hardware to test: the retry logic is
exercised with fault-injecting step functions and the heartbeat protocol
with simulated peer directories (``tests/test_torch_port_loop.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence


class PeerFailure(RuntimeError):
    """A peer process missed its heartbeat deadline."""


#: Exception types worth restarting on.  PyTorch surfaces CUDA faults
#: (launch failures, ECC errors, NCCL timeouts) as RuntimeError, and
#: ``torch.cuda.OutOfMemoryError`` subclasses it; transient filesystem
#: races on shared checkpoint storage surface as OSError.  A sticky CUDA
#: error (an illegal address) poisons the process's CUDA context: every
#: in-process retry then fails again until the budget is spent, and only
#: a process restart (layer 1's resume) heals it.  The classification
#: stays as the JAX package has it.
RETRYABLE: tuple[type[BaseException], ...] = (RuntimeError, OSError)

#: Never retry these even though they subclass a retryable type:
#: deterministic program bugs re-raise identically on every attempt,
#: and a dead peer (PeerFailure) can only be healed by a job-level
#: restart — retrying in-process would just burn the restart budget.
FATAL: tuple[type[BaseException], ...] = (
    NotImplementedError,
    RecursionError,
    PeerFailure,
)


def _is_retryable(exc: BaseException,
                  retryable: Sequence[type[BaseException]]) -> bool:
    if isinstance(exc, FATAL):
        return False
    # Python-level errors that subclass RuntimeError only via user code
    # are still retryable by the caller's explicit list; everything else
    # (TypeError, ValueError, AssertionError...) is a bug, not a fault.
    return isinstance(exc, tuple(retryable))


@dataclasses.dataclass
class RetryReport:
    """What the supervisor did: attempts made and the failures seen."""

    attempts: int = 0
    failures: list[str] = dataclasses.field(default_factory=list)


def run_with_retries(
    step: Callable[[int], object],
    *,
    max_restarts: int = 3,
    backoff_s: float = 1.0,
    backoff_factor: float = 2.0,
    retryable: Sequence[type[BaseException]] = RETRYABLE,
    on_restart: Callable[[int, BaseException], None] | None = None,
    report: RetryReport | None = None,
    _sleep: Callable[[float], None] = time.sleep,
) -> object:
    """Supervise a resumable ``step(attempt)`` with restart-on-failure.

    ``step`` must be *resumable*: on re-invocation it picks up from its
    own checkpoint (e.g. ``lambda a: loop.run(pr, dp, checkpoint_path=p)``
    — the loop's restore path makes re-running it exact).  The
    supervisor:

    - returns ``step``'s result on success;
    - on a retryable failure, waits ``backoff_s * backoff_factor**i``
      and re-invokes, at most ``max_restarts`` times;
    - re-raises immediately on non-retryable failures (bugs) and after
      the restart budget is exhausted.

    ``on_restart(attempt, exc)`` runs before each retry — the hook for
    re-creating a ``torch.distributed`` process group or freeing cached
    device memory (``torch.cuda.empty_cache()``) after a runtime fault.
    """
    report = report if report is not None else RetryReport()
    attempt = 0
    while True:
        report.attempts = attempt + 1
        try:
            return step(attempt)
        except BaseException as exc:  # noqa: BLE001 — classified below
            report.failures.append(f"{type(exc).__name__}: {exc}")
            if not _is_retryable(exc, retryable) or attempt >= max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, exc)
            _sleep(backoff_s * (backoff_factor ** attempt))
            attempt += 1


# -- peer failure detection ------------------------------------------------


@dataclasses.dataclass
class Heartbeat:
    """Shared-filesystem liveness beacon for one process.

    Each process calls ``beat()`` periodically (e.g. once per A-LINK
    iteration, alongside its checkpoint write); ``check_peers`` on any
    process reports which peers have stopped beating.  The protocol is a
    plain mtime touch — no locks, no partial-read hazard — and rides the
    same shared storage the checkpoints already use.
    """

    directory: str
    process_id: int
    num_processes: int

    def __post_init__(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        # Wall-clock of this process's FIRST beat — anchors the start-up
        # grace for peers that never appear.  Must not be the beacon's
        # mtime: beat() refreshes that every iteration, which would
        # extend the grace forever and mask a peer that never launched.
        self._first_beat: float | None = None
        # Construction time backs the grace anchor for check_peers calls
        # made BEFORE this process's own first beat (a liveness probe at
        # startup must not declare every not-yet-launched peer dead).
        self._created: float = time.time()
        # Per-process-incarnation nonce: written into the beacon so
        # barrier markers can be tied to the incarnation that wrote them
        # (stale markers from a pre-crash attempt must not satisfy a
        # post-restart barrier).
        self.session: str = os.urandom(8).hex()

    def _path(self, pid: int) -> str:
        return os.path.join(self.directory, f"heartbeat_{pid}")

    def beat(self) -> None:
        if self._first_beat is None:
            self._first_beat = time.time()
        path = self._path(self.process_id)
        # Write-temp + rename: open(path, "w") would truncate in place,
        # and a peer's racing read of the empty file at exactly the
        # barrier deadline would count this live process as missing.
        # rename() is atomic on POSIX, so readers see the old beacon or
        # the new one, never a partial/empty file.
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(self.session)
        os.replace(tmp, path)
        os.utime(path, None)

    def last_seen(self, pid: int) -> float | None:
        """Seconds since ``pid``'s last beat, or None if never seen."""
        try:
            return time.time() - os.stat(self._path(pid)).st_mtime
        except FileNotFoundError:
            return None

    def check_peers(self, timeout_s: float,
                    *, grace_s: float | None = None) -> list[int]:
        """Peer ids whose heartbeat is older than ``timeout_s``.

        Peers that have *never* beaten are only reported once
        ``grace_s`` (default ``timeout_s``) has elapsed since this
        process's own first beat — start-up isn't a failure.
        """
        grace = timeout_s if grace_s is None else grace_s
        # Anchor: first beat if any, else construction — a probe before
        # this process's own first beat is still start-up, not failure.
        since_first = time.time() - (self._first_beat
                                     if self._first_beat is not None
                                     else self._created)
        dead = []
        for pid in range(self.num_processes):
            if pid == self.process_id:
                continue
            age = self.last_seen(pid)
            if age is None:
                if since_first <= grace:
                    continue  # still inside start-up grace
                dead.append(pid)
            elif age > timeout_s:
                dead.append(pid)
        return dead

    def ensure_peers_alive(self, timeout_s: float) -> None:
        """Raise ``PeerFailure`` naming any dead peers."""
        dead = self.check_peers(timeout_s)
        if dead:
            raise PeerFailure(
                f"process(es) {dead} missed the {timeout_s:.0f}s heartbeat "
                f"deadline (seen from process {self.process_id})")


def _drop_marker(hb: Heartbeat, name: str) -> None:
    """Write this process's barrier marker, stamped with its session."""
    marker = os.path.join(hb.directory, f"{name}_{hb.process_id}")
    with open(marker, "w") as f:
        f.write(hb.session)


def _marker_session(hb: Heartbeat, name: str, pid: int) -> str | None:
    try:
        with open(os.path.join(hb.directory, f"{name}_{pid}")) as f:
            return f.read()
    except FileNotFoundError:
        return None


def _peer_session(hb: Heartbeat, pid: int) -> str | None:
    try:
        with open(hb._path(pid)) as f:
            return f.read()
    except FileNotFoundError:
        return None


def barrier(
    hb: Heartbeat,
    name: str,
    *,
    timeout_s: float = 600.0,
    poll_s: float = 0.2,
    _sleep: Callable[[float], None] = time.sleep,
    _clock: Callable[[], float] = time.monotonic,
) -> None:
    """File-based barrier with a deadline (unlike a collective, it FAILS
    instead of hanging when a peer died).

    Every process drops ``<name>_<pid>`` stamped with its heartbeat
    session and waits until all ``num_processes`` markers are present
    AND current; raises ``PeerFailure`` on timeout.  Callers must use a
    fresh ``name`` per synchronisation point (e.g. suffix the iteration
    number).

    Restart safety: a marker counts only if its session stamp matches
    the peer's CURRENT heartbeat beacon — markers left on the shared
    filesystem by a pre-crash attempt carry the old incarnation's
    session, so a resumed job re-synchronises for real instead of
    sailing through stale markers.  Waiting in the barrier beats every
    poll (the wait IS this process's liveness).
    """
    hb.beat()  # beacon carries our session before anyone reads the marker
    _drop_marker(hb, name)
    deadline = _clock() + timeout_s

    def _present(p: int) -> bool:
        if p == hb.process_id:
            return True
        ms = _marker_session(hb, name, p)
        return ms is not None and ms == _peer_session(hb, p)

    while True:
        if all(_present(p) for p in range(hb.num_processes)):
            return
        if _clock() > deadline:
            missing = [p for p in range(hb.num_processes)
                       if not _present(p)]
            raise PeerFailure(
                f"barrier '{name}' timed out after {timeout_s:.0f}s; "
                f"missing process(es) {missing}")
        _sleep(poll_s)
        hb.beat()
