"""Op-deadline retry policy — capped exponential backoff, deterministic
jitter.

A copy of ``mpit_tpu/ft/retry.py``: the port imports nothing of the JAX
package.

The client retries a timed-out PS op by resending the *staged* frame
(same bytes, same [epoch, seq] header), so a retry is idempotent on the
wire and the server's dedup table makes it idempotent in effect.  This
module only decides *when* to resend.

Jitter is deterministic — a pure function of (key, attempt) via a
splitmix64 mix rather than ``random`` — for the same reason the fault
plan is seed-deterministic: a recovery schedule that can't be replayed
can't be debugged or regression-tested.  Decorrelation across clients
comes from keying the policy on the client rank, not from entropy.
"""

from __future__ import annotations

from mpit_tpu_torch.ft.config import FTConfig

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """Deterministic 64-bit mix (the splitmix64 finalizer)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


class RetryExhausted(RuntimeError):
    """An op failed every allowed attempt; the caller must fail loudly —
    never hang — so the gang monitor (or the user) sees a real error."""

    def __init__(self, what: str, attempts: int, last: BaseException):
        super().__init__(
            f"{what} failed after {attempts} attempt(s); last error: {last!r}"
        )
        self.what = what
        self.attempts = attempts
        self.last = last


class RetryPolicy:
    """Backoff schedule for one client endpoint (``key`` = client rank)."""

    def __init__(self, cfg: FTConfig, key: int = 0):
        self.cfg = cfg
        self.key = key

    @property
    def attempts(self) -> int:
        """Total tries per op: the first send plus max_retries resends."""
        return 1 + max(self.cfg.max_retries, 0)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before resend number ``attempt`` (1-based): capped
        exponential plus up to 50% deterministic jitter."""
        base = min(
            self.cfg.backoff_base_s * (2 ** (attempt - 1)),
            self.cfg.backoff_cap_s,
        )
        frac = _splitmix64((self.key << 20) ^ attempt) / float(_MASK)
        return base * (1.0 + 0.5 * frac)
