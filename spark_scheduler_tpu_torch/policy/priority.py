"""Priority tiers with age-based anti-starvation promotion.

Borg-style priority bands (Verma et al., EuroSys '15 §2.3) reduced to four
named classes; a gang's class rides the `spark-priority-class` annotation on
its driver pod and is stamped onto the ResourceReservation at admission
(models/reservations.py) so running gangs keep their tier after the driver
pod is gone.

Anti-starvation: a pending gang's *effective* priority is promoted one tier
per `promote_after_s` of queue age, capped at "high" — a low-priority gang
waiting long enough eventually outranks fresh high-priority arrivals
(bounded starvation), but nothing ages into "system", so the protected
class stays strictly above all promotable work.

The port's copy of spark_scheduler_tpu/policy/priority.py.
"""

from __future__ import annotations

from spark_scheduler_tpu_torch.models.reservations import PRIORITY_CLASS_ANNOTATION  # noqa: F401

PRIORITY_CLASSES: dict[str, int] = {
    "low": 0,
    "default": 100,
    "high": 200,
    "system": 300,
}
DEFAULT_PRIORITY = PRIORITY_CLASSES["default"]
PROMOTION_STEP = 100  # one tier per promotion interval
PROMOTION_CAP = PRIORITY_CLASSES["high"]  # aging never reaches "system"
PROTECTED_PRIORITY = PRIORITY_CLASSES["system"]


def parse_priority_class(value: str | None) -> int:
    """Class name or bare integer -> numeric priority; unknown/absent ->
    default. Unknowns map to default rather than raising because the value
    arrives on user-authored pods, not operator config."""
    if value is None:
        return DEFAULT_PRIORITY
    v = value.strip().lower()
    if v in PRIORITY_CLASSES:
        return PRIORITY_CLASSES[v]
    try:
        return int(v)
    except ValueError:
        return DEFAULT_PRIORITY


def pod_priority(pod) -> int:
    """Numeric priority of a driver pod (annotation, default tier absent)."""
    return parse_priority_class(
        (pod.annotations or {}).get(PRIORITY_CLASS_ANNOTATION)
    )


def effective_priority(base: int, age_s: float, promote_after_s: float) -> int:
    """Queue-age-promoted priority: +1 tier per full `promote_after_s` of
    age, capped at "high". A base already at/above the cap is unchanged
    (promotion never demotes, never reaches "system")."""
    if promote_after_s <= 0 or age_s <= 0 or base >= PROMOTION_CAP:
        return base
    steps = int(age_s // promote_after_s)
    if steps <= 0:
        return base
    return min(PROMOTION_CAP, base + steps * PROMOTION_STEP)
