"""Priority classes — the small class table placement policy runs on.

A :class:`PriorityClass` is (name → class priority, preemptible flag),
the Kubernetes PriorityClass idea re-expressed for the bridge: the CLASS
decides who wins contention and who may be displaced, while the numeric
``spec.priority`` a user writes only breaks ties *within* a class. That
split is what prevents priority inversion: a production gang with a
modest numeric priority must still displace a best-effort job that
happens to carry ``priority=99``.

Resolution order for a pod (``resolve``):

1. the ``sbt.kubecluster.org/priority-class`` label (set on the
   BridgeJob, mirrored onto the sizecar pod by the operator);
2. the table's default class otherwise.

An unknown label falls back to the default class with a rate-limited
warning — a typo'd class name must degrade, not fail admission.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

log = logging.getLogger("sbt.policy")

#: pod/job label carrying the priority-class name
CLASS_LABEL = "sbt.kubecluster.org/priority-class"
#: pod/job label carrying the tenant name (fair-share accounting key)
TENANT_LABEL = "sbt.kubecluster.org/tenant"


@dataclass(frozen=True)
class PriorityClass:
    """One row of the class table.

    ``priority`` orders classes (higher wins contention); ``preemptible``
    gates the OTHER side: whether running work of this class may be
    displaced by a higher class. A non-preemptible class can still *cause*
    preemption — it just never suffers it.
    """

    name: str
    priority: int
    preemptible: bool = True


#: the default table — deliberately small, mirroring the shapes the
#: papers score against ("Priority Matters", arxiv 2511.08373): scavenger
#: work, the bulk batch tier, latency-sensitive production, and a system
#: tier that nothing may displace
DEFAULT_CLASSES: tuple[PriorityClass, ...] = (
    PriorityClass("best-effort", 0, preemptible=True),
    PriorityClass("batch", 100, preemptible=True),
    PriorityClass("production", 200, preemptible=False),
    PriorityClass("system", 1000, preemptible=False),
)

_WARNED_UNKNOWN: set[str] = set()


class ClassTable:
    """Name → :class:`PriorityClass` lookup with a default fallback.

    ``rank_of`` maps a class to its dense index in ascending class-
    priority order — the small integers the effective-priority encoding
    uses (class priorities themselves can be sparse and large; the dense
    rank keeps solver priorities exactly representable in float32).
    """

    def __init__(
        self,
        classes: tuple[PriorityClass, ...] = DEFAULT_CLASSES,
        *,
        default: str = "batch",
    ):
        if not classes:
            raise ValueError("class table cannot be empty")
        self.classes = tuple(sorted(classes, key=lambda c: (c.priority, c.name)))
        self.by_name = {c.name: c for c in self.classes}
        if default not in self.by_name:
            raise ValueError(
                f"default class {default!r} not in table "
                f"({', '.join(self.by_name)})"
            )
        self.default = self.by_name[default]
        self._rank = {c.name: i for i, c in enumerate(self.classes)}

    def __len__(self) -> int:
        return len(self.classes)

    def resolve(self, labels) -> PriorityClass:
        """The class for a pod given its labels (None-safe)."""
        name = labels.get(CLASS_LABEL, "") if labels else ""
        if not name:
            return self.default
        cls = self.by_name.get(name)
        if cls is None:
            if name not in _WARNED_UNKNOWN:
                _WARNED_UNKNOWN.add(name)
                log.warning(
                    "unknown priority class %r (known: %s); using default %r",
                    name, ", ".join(self.by_name), self.default.name,
                )
            return self.default
        return cls

    def rank_of(self, cls: PriorityClass) -> int:
        """Dense ascending index of ``cls`` (0 = lowest class)."""
        return self._rank[cls.name]
