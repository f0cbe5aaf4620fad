"""Owner-aware, reentrant, and fenced lock models, plus a permit
(semaphore) model.

A copy of :mod:`jepsen_tpu.models.locks` (same steps, reprs, equality and
hashing), so oracle results compare equal across the two packages.

These mirror the hazelcast suite's CP-subsystem probes (reference:
hazelcast/src/jepsen/hazelcast.clj:515-650): unlike the plain
:class:`..Mutex`, each step knows WHICH client acted — an op's value
carries the client name (or a ``{"client": ..., "fence": ...}`` map for
the fenced flavors) — so the models catch a lock granted to two owners,
a release by a non-owner, more re-acquires than the configured bound,
fencing tokens that go backwards, and over-issued semaphore permits.

Fences use the reference's convention: 0 is the "invalid" (absent)
fence (hazelcast.clj:55); a real fence must strictly exceed every fence
observed so far.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from . import Model, inconsistent

#: a lock may be re-acquired at most this many times by its owner
#: (reference: hazelcast.clj:53 reentrant-lock-acquire-count)
REENTRANT_ACQUIRE_COUNT = 2

#: the "no fence" sentinel (reference: hazelcast.clj:55 invalid-fence)
INVALID_FENCE = 0


def _client(op) -> Optional[str]:
    v = op.value
    if isinstance(v, dict):
        return v.get("client")
    return v


def _fence(op) -> int:
    v = op.value
    if isinstance(v, dict):
        return int(v.get("fence", INVALID_FENCE))
    return INVALID_FENCE


class OwnerMutex(Model):
    """Non-reentrant mutex that tracks WHO holds it: acquire needs a
    free lock; release must come from the holder.  (reference:
    hazelcast.clj:538-557 OwnerAwareMutex)"""

    __slots__ = ("owner",)

    def __init__(self, owner: Optional[str] = None):
        self.owner = owner

    def step(self, op) -> Model:
        client = _client(op)
        if client is None:
            return inconsistent("no owner!")
        if op.f == "acquire":
            if self.owner is None:
                return OwnerMutex(client)
            return inconsistent(
                f"client {client} cannot acquire: held by {self.owner}"
            )
        if op.f == "release":
            if self.owner is None or self.owner != client:
                return inconsistent(
                    f"client {client} cannot release: held by {self.owner}"
                )
            return OwnerMutex(None)
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return isinstance(other, OwnerMutex) and other.owner == self.owner

    def __hash__(self):
        return hash(("owner-mutex", self.owner))

    def __repr__(self):
        return f"OwnerMutex(owner={self.owner!r})"


class ReentrantMutex(Model):
    """Mutex the holder may re-acquire, up to ``max_count`` holds; every
    release peels one hold.  (reference: hazelcast.clj:515-535
    ReentrantMutex)"""

    __slots__ = ("owner", "count", "max_count")

    def __init__(
        self,
        owner: Optional[str] = None,
        count: int = 0,
        max_count: int = REENTRANT_ACQUIRE_COUNT,
    ):
        self.owner = owner
        self.count = count
        self.max_count = max_count

    def step(self, op) -> Model:
        client = _client(op)
        if client is None:
            return inconsistent("no owner!")
        if op.f == "acquire":
            if self.count < self.max_count and (
                self.owner is None or self.owner == client
            ):
                return ReentrantMutex(client, self.count + 1, self.max_count)
            return inconsistent(
                f"client {client} cannot acquire: owner={self.owner} "
                f"count={self.count}"
            )
        if op.f == "release":
            if self.owner is None or self.owner != client:
                return inconsistent(
                    f"client {client} cannot release: owner={self.owner}"
                )
            return ReentrantMutex(
                None if self.count == 1 else self.owner,
                self.count - 1,
                self.max_count,
            )
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return (
            isinstance(other, ReentrantMutex)
            and other.owner == self.owner
            and other.count == self.count
            and other.max_count == self.max_count
        )

    def __hash__(self):
        return hash(("reentrant-mutex", self.owner, self.count))

    def __repr__(self):
        return f"ReentrantMutex(owner={self.owner!r}, count={self.count})"


class FencedMutex(Model):
    """Non-reentrant mutex whose acquires may carry a fencing token; a
    real token must strictly exceed the largest fence ever observed
    (a stale or reused token is the anomaly this model exists to
    catch).  (reference: hazelcast.clj:565-587 FencedMutex)"""

    __slots__ = ("owner", "fence")

    def __init__(
        self, owner: Optional[str] = None, fence: int = INVALID_FENCE
    ):
        self.owner = owner
        self.fence = fence

    def step(self, op) -> Model:
        client = _client(op)
        if client is None:
            return inconsistent("no owner!")
        fence = _fence(op)
        if op.f == "acquire":
            if self.owner is not None:
                return inconsistent(
                    f"client {client} cannot acquire: held by {self.owner}"
                )
            if fence == INVALID_FENCE:
                return FencedMutex(client, self.fence)
            if fence > self.fence:
                return FencedMutex(client, fence)
            return inconsistent(
                f"client {client} acquired with non-monotonic fence "
                f"{fence} (highest observed {self.fence})"
            )
        if op.f == "release":
            if self.owner is None or self.owner != client:
                return inconsistent(
                    f"client {client} cannot release: held by {self.owner}"
                )
            return FencedMutex(None, self.fence)
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return (
            isinstance(other, FencedMutex)
            and other.owner == self.owner
            and other.fence == self.fence
        )

    def __hash__(self):
        return hash(("fenced-mutex", self.owner, self.fence))

    def __repr__(self):
        return f"FencedMutex(owner={self.owner!r}, fence={self.fence})"


class ReentrantFencedMutex(Model):
    """Reentrant mutex with fencing tokens: a fresh hold must present a
    new (strictly larger) fence or none; re-acquires by the holder must
    reuse the hold's fence or none.  (reference: hazelcast.clj:590-627
    ReentrantFencedMutex)"""

    __slots__ = ("owner", "count", "fence", "highest", "max_count")

    def __init__(
        self,
        owner: Optional[str] = None,
        count: int = 0,
        fence: int = INVALID_FENCE,
        highest: int = INVALID_FENCE,
        max_count: int = REENTRANT_ACQUIRE_COUNT,
    ):
        self.owner = owner
        self.count = count
        self.fence = fence  # the current hold's fence
        self.highest = highest  # largest fence ever observed
        self.max_count = max_count

    def step(self, op) -> Model:
        client = _client(op)
        if client is None:
            return inconsistent("no owner!")
        fence = _fence(op)
        bad = inconsistent(
            f"client {client} cannot {op.f} (fence {fence}) on {self!r}"
        )
        if op.f == "acquire":
            if self.owner is None:
                # fresh hold: fenceless, or a fence past everything seen
                if fence == INVALID_FENCE or fence > self.highest:
                    return ReentrantFencedMutex(
                        client, 1, fence, max(fence, self.highest),
                        self.max_count,
                    )
                return bad
            if self.owner != client or self.count == self.max_count:
                return bad
            if self.fence == INVALID_FENCE:
                # hold began fenceless: a re-acquire may introduce a
                # (strictly newer) fence, or stay fenceless
                if fence == INVALID_FENCE or fence > self.highest:
                    return ReentrantFencedMutex(
                        client, self.count + 1, fence,
                        max(fence, self.highest), self.max_count,
                    )
                return bad
            # hold is fenced: re-acquires reuse its fence or none
            if fence == INVALID_FENCE or fence == self.fence:
                return ReentrantFencedMutex(
                    client, self.count + 1, self.fence, self.highest,
                    self.max_count,
                )
            return bad
        if op.f == "release":
            if self.owner is None or self.owner != client:
                return bad
            if self.count == 1:
                return ReentrantFencedMutex(
                    None, 0, INVALID_FENCE, self.highest, self.max_count
                )
            return ReentrantFencedMutex(
                self.owner, self.count - 1, self.fence, self.highest,
                self.max_count,
            )
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return (
            isinstance(other, ReentrantFencedMutex)
            and other.owner == self.owner
            and other.count == self.count
            and other.fence == self.fence
            and other.highest == self.highest
        )

    def __hash__(self):
        return hash(
            ("reentrant-fenced-mutex", self.owner, self.count, self.fence,
             self.highest)
        )

    def __repr__(self):
        return (
            f"ReentrantFencedMutex(owner={self.owner!r}, "
            f"count={self.count}, fence={self.fence}, "
            f"highest={self.highest})"
        )


class AcquiredPermits(Model):
    """Semaphore: at most ``n_permits`` held across all clients, and a
    client may only release permits it holds.  (reference:
    hazelcast.clj:630-650 AcquiredPermitsModel, num-permits=2)"""

    __slots__ = ("n_permits", "acquired")

    def __init__(
        self,
        n_permits: int = 2,
        acquired: Tuple[Tuple[str, int], ...] = (),
    ):
        self.n_permits = n_permits
        self.acquired = acquired  # sorted ((client, count), ...)

    def _counts(self) -> dict:
        return dict(self.acquired)

    @staticmethod
    def _pack(counts: dict) -> Tuple[Tuple[str, int], ...]:
        return tuple(sorted((k, v) for k, v in counts.items() if v))

    def step(self, op) -> Model:
        client = _client(op)
        if client is None:
            return inconsistent("no owner!")
        counts = self._counts()
        if op.f == "acquire":
            if sum(counts.values()) < self.n_permits:
                counts[client] = counts.get(client, 0) + 1
                return AcquiredPermits(self.n_permits, self._pack(counts))
            return inconsistent(
                f"client {client} cannot acquire: all {self.n_permits} "
                "permits held"
            )
        if op.f == "release":
            if counts.get(client, 0) > 0:
                counts[client] -= 1
                return AcquiredPermits(self.n_permits, self._pack(counts))
            return inconsistent(
                f"client {client} releases a permit it does not hold"
            )
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return (
            isinstance(other, AcquiredPermits)
            and other.n_permits == self.n_permits
            and other.acquired == self.acquired
        )

    def __hash__(self):
        return hash(("acquired-permits", self.n_permits, self.acquired))

    def __repr__(self):
        return (
            f"AcquiredPermits(n={self.n_permits}, "
            f"acquired={dict(self.acquired)!r})"
        )


def owner_mutex() -> OwnerMutex:
    return OwnerMutex()


def reentrant_mutex(
    max_count: int = REENTRANT_ACQUIRE_COUNT,
) -> ReentrantMutex:
    return ReentrantMutex(max_count=max_count)


def fenced_mutex() -> FencedMutex:
    return FencedMutex()


def reentrant_fenced_mutex(
    max_count: int = REENTRANT_ACQUIRE_COUNT,
) -> ReentrantFencedMutex:
    return ReentrantFencedMutex(max_count=max_count)


def acquired_permits(n_permits: int = 2) -> AcquiredPermits:
    return AcquiredPermits(n_permits)
