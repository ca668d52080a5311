"""Upload choke economics: DRR byte-deficits over unchoke rounds.

The hash-plane scheduler taught this codebase one fairness idiom — deficit
round robin with byte quanta (``deficit += max(1, int(quantum *
weight))``, spend on service, no credit hoarding). This module applies
it to the seeder's unchoke decision:

* every **interested** candidate accrues deficit each round in
  proportion to its reciprocation weight (with a floor, so a newcomer
  that has never uploaded to us still accrues — starvation is
  structurally impossible: a candidate that keeps losing keeps
  accumulating until it outranks the incumbents);
* the top :attr:`slots` candidates by deficit are unchoked;
* one extra **optimistic** slot rotates on a seeded RNG every
  :attr:`optimistic_every` rounds among the candidates that did NOT win
  a regular slot (BEP 3 discovery — new peers get a trial upload);
* actual egress **spends** deficit (:meth:`charge`), charged at the
  same site the upload ``TokenBucket`` is debited, so a leecher that
  drinks its unchoke dry re-enters the queue behind the patient ones;
* deficits are capped at :attr:`cap_rounds` quanta — an idle candidate
  cannot hoard unbounded credit and then monopolize the seeder.

The class is **purely deterministic**: no wall clock, all randomness
from one seeded :class:`random.Random`. The session drives it with
monotonic rounds; the scenario plane drives it with virtual ticks and
replays bit-identically.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

__all__ = ["ChokeEconomics", "RoundResult"]

# deficit accrual floor as a weight: a peer that never reciprocated
# still accrues 5% of a quantum per round (plus the max(1,...) floor)
MIN_WEIGHT = 0.05


@dataclass
class RoundResult:
    """One unchoke round's verdict."""

    unchoked: list = field(default_factory=list)  # regular-slot winners
    optimistic: str | None = None  # the rotating discovery slot
    rotated: bool = False  # did the optimistic slot move this round?

    def all_unchoked(self) -> list:
        out = list(self.unchoked)
        if self.optimistic is not None and self.optimistic not in out:
            out.append(self.optimistic)
        return out


class ChokeEconomics:
    """Deterministic DRR unchoke ranking for one seeder.

    ``slots``: regular unchoke slots (the optimistic slot is extra,
    matching the session's ``unchoke_slots + 1`` convention).
    ``quantum``: bytes of deficit a weight-1.0 candidate accrues per
    round (the scheduler's DRR quantum, 16 KiB = one block by default).
    """

    def __init__(
        self,
        slots: int = 3,
        quantum: int = 16384,
        seed: int = 0,
        cap_rounds: int = 8,
        optimistic_every: int = 3,
    ):
        self.slots = max(0, int(slots))
        self.quantum = max(1, int(quantum))
        self.cap_rounds = max(1, int(cap_rounds))
        self.optimistic_every = max(1, int(optimistic_every))
        self._rng = random.Random(seed)
        self._deficit: dict[str, int] = {}
        self._optimistic: str | None = None
        self.rounds = 0
        self.rotations = 0

    def deficit(self, key: str) -> int:
        return self._deficit.get(key, 0)

    def charge(self, key: str, nbytes: int) -> None:
        """Spend deficit for actual egress (clamped at zero — a burst
        larger than the balance doesn't go into debt, it just lands the
        peer at the back of the queue)."""
        if key in self._deficit:
            self._deficit[key] = max(0, self._deficit[key] - max(0, int(nbytes)))

    def round(self, weights: dict) -> RoundResult:
        """Run one unchoke round over the interested candidates.

        ``weights``: key -> reciprocation weight (>= 0; the session
        passes normalized ``upload_rate``/``download_rate``). State for
        keys absent from ``weights`` is dropped — a departed or
        no-longer-interested peer stops accruing immediately.
        """
        self.rounds += 1
        cap = self.cap_rounds * self.quantum
        for key in list(self._deficit):
            if key not in weights:
                del self._deficit[key]
        for key in sorted(weights, key=str):
            w = max(MIN_WEIGHT, float(weights[key]))
            accrued = self._deficit.get(key, 0) + max(1, int(self.quantum * w))
            self._deficit[key] = min(cap, accrued)
        order = sorted(self._deficit, key=lambda k: (-self._deficit[k], k))
        unchoked = order[: self.slots]
        rest = order[self.slots:]
        rotated = False
        if self._optimistic not in weights:
            self._optimistic = None
        due = (self.rounds % self.optimistic_every) == 1 or (
            self.optimistic_every == 1
        )
        if rest and (self._optimistic is None or due):
            pick = rest[self._rng.randrange(len(rest))]
            if pick != self._optimistic:
                self._optimistic = pick
                self.rotations += 1
                rotated = True
        elif not rest:
            # everyone interested already holds a regular slot
            self._optimistic = None
        return RoundResult(
            unchoked=unchoked, optimistic=self._optimistic, rotated=rotated
        )
