"""Deterministic fault injection for the serving fleet (port of
`repro.serving.faults`, unchanged: host-side numpy only).

The fleet's fault model is fail-stop at three seams, each one an
explicit hook in `ServingEngine`:

* **Replica crash** (`CrashFault` -> `ReplicaCrash`), raised at the top
  of `ServingEngine.step()` before any state mutates.  The crashed
  replica's device state (KV pool, slots, queue) is considered lost;
  the front-end marks it down and re-dispatches its work.  A crash is
  scheduled by engine-local step index, so adversarial points —
  mid-chunked-prefill, mid-decode, mid-speculation, the step a staged
  weight push would land — are all reachable by choosing the index.
  `transient` crashes restart after `down_steps` fleet steps: the
  front-end cold-resets the replica (`reset_for_rejoin`) and it rejoins
  only once it has installed the current fleet weight version.

* **Weight-install failure** (`InstallFault` -> `WeightInstallError`),
  raised inside `ServingEngine.install_weights` BEFORE params/version
  mutate — installs are replica-atomic by construction (raise-before-
  mutate), so "partial install" can only exist at fleet scope (some
  replicas took the push, some did not), which is exactly what the
  front-end's stage-all-then-commit push with bounded retry +
  quarantine resolves.  `times` bounds consecutive failures (a
  transient NIC hiccup); `times < 0` means the replica can never take
  the version (permanent — it ends quarantined).

* **Host-copy failure** (`HostCopyFault` -> `HostCopyError`), raised
  from the engine's `demote_copy` hook — the synchronous evictor
  demote-before-drop path.  The content being demoted is a refcount-0
  *cache* entry, so the allocator recovers by dropping the prefix entry
  instead (the pre-host-tier behavior): strictly a performance loss,
  never a correctness loss.  Live swap-out copies are NOT a fault
  point — a lost live copy is a crash, not a degraded copy.

Everything is deterministic: a `FaultPlan` is plain data (what fires,
where, when), `FaultPlan.random(seed, ...)` derives one from a seed,
and the injector consumes the plan by counting engine-local events —
no wall clock, no global RNG.  `NULL_INJECTOR` mirrors `NULL_TRACER`:
every engine seam is a single ``if self.faults.enabled:`` branch, so a
fault-free fleet is bit-exact vs a fleet built before this module
existed (the zero-perturbation gate in `benchmarks/fault_tolerance.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


class FaultError(RuntimeError):
    """Base class for every injected fault."""


class ReplicaCrash(FaultError):
    """A replica failed fail-stop at a step boundary."""

    def __init__(self, replica: int, step: int, *, transient: bool,
                 down_steps: int):
        self.replica = replica
        self.step = step
        self.transient = transient
        self.down_steps = down_steps
        kind = "transient" if transient else "permanent"
        super().__init__(
            f"replica {replica} crashed ({kind}) at engine step {step}")


class WeightInstallError(FaultError):
    """A weight install failed before any engine state mutated."""

    def __init__(self, replica: int, version: int):
        self.replica = replica
        self.version = version
        super().__init__(
            f"replica {replica} failed to install weight version {version}")


class HostCopyError(FaultError):
    """A device->host cache-demotion copy failed."""

    def __init__(self, replica: int, index: int):
        self.replica = replica
        self.index = index
        super().__init__(
            f"replica {replica} host-copy #{index} failed")


@dataclasses.dataclass(frozen=True)
class CrashFault:
    """Crash `replica` when its engine's `step()` is entered for the
    `step`-th time (0-based, counting attempts — a retried step after a
    recovered install failure advances the counter too)."""

    replica: int
    step: int
    transient: bool = False
    down_steps: int = 3        # fleet steps down before the rejoin attempt


@dataclasses.dataclass(frozen=True)
class InstallFault:
    """Fail `replica`'s install of weight `version`.  `times` consecutive
    attempts fail, then installs succeed (transient); `times < 0` fails
    every attempt (permanent — the push quarantines the replica)."""

    replica: int
    version: int
    times: int = 1


@dataclasses.dataclass(frozen=True)
class HostCopyFault:
    """Fail `replica`'s `index`-th evictor demote-copy (0-based)."""

    replica: int
    index: int = 0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic fault schedule: plain data, no state.  The
    empty plan injects nothing (and a `FaultInjector` over it must be
    bit-exact vs `NULL_INJECTOR` — the zero-perturbation contract)."""

    crashes: Tuple[CrashFault, ...] = ()
    installs: Tuple[InstallFault, ...] = ()
    host_copies: Tuple[HostCopyFault, ...] = ()

    @property
    def empty(self) -> bool:
        return not (self.crashes or self.installs or self.host_copies)

    @classmethod
    def random(cls, seed: int, *, replicas: int, max_step: int,
               n_crashes: int = 1, p_transient: float = 0.5,
               down_steps: int = 3) -> "FaultPlan":
        """Seeded random crash schedule (crash step x replica x kind) —
        the chaos generator the property tests and the benchmark's
        random sweep draw from.  At most `replicas - 1` permanent
        crashes are drawn, so at least one survivor always exists and
        the no-loss contract stays satisfiable."""
        rng = np.random.default_rng(seed)
        n = min(n_crashes, replicas)
        picks = rng.choice(replicas, size=n, replace=False)
        crashes = []
        permanent_left = replicas - 1
        for r in picks:
            transient = bool(rng.random() < p_transient)
            if not transient:
                if permanent_left == 0:
                    transient = True
                else:
                    permanent_left -= 1
            crashes.append(CrashFault(
                replica=int(r), step=int(rng.integers(0, max(max_step, 1))),
                transient=transient, down_steps=down_steps))
        return cls(crashes=tuple(crashes))


class NullInjector:
    """Disabled injector: the default.  `enabled` is False and every
    hook is absent by design — engine seams must check `enabled` first,
    which keeps the fault-free hot path at one branch per seam (the
    same contract as `obs.tracer.NullTracer`)."""

    __slots__ = ()
    enabled = False


NULL_INJECTOR = NullInjector()


class FaultInjector:
    """Consumes a `FaultPlan` by counting engine-local events.

    One injector serves the whole fleet (faults key on
    `engine.replica_index`, which `ServingFrontend` assigns).  All
    counters are deterministic functions of the call sequence:
    `on_step` counts `step()` entries per replica, `on_demote_copy`
    counts evictor demote-copies per replica, and `on_install` burns
    down each `InstallFault.times` budget per attempt.  `injected`
    tallies what actually fired, so a chaos run can assert its plan was
    exercised (a fault scheduled past the end of the trace fires
    nothing — and proves nothing)."""

    enabled = True

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._steps: Dict[int, int] = {}
        self._copies: Dict[int, int] = {}
        self._crashes = {(c.replica, c.step): c for c in plan.crashes}
        self._install_left = {(f.replica, f.version): f.times
                              for f in plan.installs}
        self._copy_faults = {(f.replica, f.index) for f in plan.host_copies}
        self.injected = dict(crashes=0, install_failures=0,
                             host_copy_failures=0)

    # -- engine seams --------------------------------------------------------
    def on_step(self, eng) -> None:
        """Called at the top of `ServingEngine.step()`, before any state
        mutates.  Raises `ReplicaCrash` when the plan says so (once per
        scheduled crash — a transient replica that rejoined keeps
        counting from where it crashed and does not re-fire)."""
        r = eng.replica_index
        k = self._steps.get(r, 0)
        self._steps[r] = k + 1
        crash = self._crashes.pop((r, k), None)
        if crash is not None:
            self.injected["crashes"] += 1
            raise ReplicaCrash(r, k, transient=crash.transient,
                               down_steps=crash.down_steps)

    def on_install(self, eng, version: int) -> None:
        """Called from `install_weights` before params/version mutate."""
        r = eng.replica_index
        left = self._install_left.get((r, version))
        if left is None or left == 0:
            return
        if left > 0:
            self._install_left[(r, version)] = left - 1
        self.injected["install_failures"] += 1
        raise WeightInstallError(r, version)

    def on_demote_copy(self, eng) -> None:
        """Called from the engine's `demote_copy` hook (evictor
        demote-before-drop) before the host copy is written."""
        r = eng.replica_index
        k = self._copies.get(r, 0)
        self._copies[r] = k + 1
        if (r, k) in self._copy_faults:
            self.injected["host_copy_failures"] += 1
            raise HostCopyError(r, k)
