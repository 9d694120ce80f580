"""Freeze-guard primitives + guard-bypassing dataclass constructors.

Lives in ``core`` (no bridge imports) so the wire decoders and the sim's
fake agent can use the fast constructors without pulling in the bridge
package; :mod:`bridge.freeze` builds its public API on top and re-exports
everything here.

Why this exists (PR-4): once a dataclass type has passed through
:func:`bridge.freeze.freeze`, its ``__init__`` pays a guarded
``__setattr__`` per field — measured 4× construction cost on the
18-field ``JobInfo`` — and the store's commit-time :func:`freeze` walks
every field of every fresh object. The cold-start paths build ~140k such
objects per tick at the 50k×10k headline shape. The helpers below
sidestep both costs without weakening the guard:

- :func:`fast_replace` / :func:`fast_new` build UNFROZEN instances
  straight into ``__dict__`` (no guarded ``__init__`` replay); the store
  freezes them on commit like any other fresh object;
- :func:`frozen_new` additionally marks the instance frozen at birth —
  legal ONLY for scalar-field dataclasses (strings/ints/enums/datetimes),
  where there is nothing recursive left for ``freeze`` to do. It patches
  the class guard first, so a born-frozen instance rejects mutation
  exactly like a store snapshot.
"""

from __future__ import annotations

import copy

#: instance-level marker: present and True on frozen instances
FROZEN_FLAG = "_sbt_frozen"
#: class-level marker: the guard has been installed on this type
PATCHED_FLAG = "_sbt_freezable"


class FrozenInstanceError(AttributeError):
    """Raised on any attempt to mutate a frozen store snapshot.

    Callers holding a snapshot from ``get``/``list`` must go through
    ``ObjectStore.mutate`` / ``get_for_update`` (or ``freeze.thaw``) to
    write.
    """


def _guarded_setattr(self, name, value):
    if self.__dict__.get(FROZEN_FLAG, False):
        raise FrozenInstanceError(
            f"{type(self).__name__} is a frozen store snapshot; use "
            "ObjectStore.mutate/get_for_update (or freeze.thaw) to modify"
        )
    object.__setattr__(self, name, value)


def _guarded_delattr(self, name):
    if self.__dict__.get(FROZEN_FLAG, False):
        raise FrozenInstanceError(
            f"{type(self).__name__} is a frozen store snapshot"
        )
    object.__delattr__(self, name)


def _thawing_deepcopy(self, memo):
    """deepcopy of a (possibly frozen) instance yields a thawed one."""
    cls = self.__class__
    new = cls.__new__(cls)
    memo[id(self)] = new
    for k, v in self.__dict__.items():
        if k == FROZEN_FLAG:
            continue
        object.__setattr__(new, k, copy.deepcopy(v, memo))
    return new


def enable_guard(cls: type) -> None:
    """Teach a dataclass type the frozen guard (idempotent, per-class)."""
    if cls.__dict__.get(PATCHED_FLAG, False):
        return
    cls.__setattr__ = _guarded_setattr
    cls.__delattr__ = _guarded_delattr
    cls.__deepcopy__ = _thawing_deepcopy
    setattr(cls, PATCHED_FLAG, True)


def fast_replace(obj, **changes):
    """``dataclasses.replace`` for the hot write paths (PR-4).

    A shallow replacement built straight into ``__dict__`` — no guarded
    ``__init__`` replay, no default re-evaluation — and UNFROZEN, so the
    store can take ownership (bump ``resource_version``, re-freeze) like
    any fresh replacement. Unchanged children are shared as-is: sharing a
    frozen child between versions is exactly the structural-sharing
    contract ``ObjectStore.replace_update`` already relies on.

    Caveat: ``__init__``/``__post_init__`` side effects are skipped, so
    only use it on plain field-bag dataclasses (everything in
    ``bridge/objects.py`` and ``core/types.py`` qualifies).
    """
    cls = obj.__class__
    new = cls.__new__(cls)
    d = new.__dict__
    d.update(obj.__dict__)
    d.pop(FROZEN_FLAG, None)
    d.update(changes)
    return new


def fast_new(cls, **fields):
    """Construct a dataclass instance straight into ``__dict__``,
    bypassing a (possibly freeze-guarded) ``__init__``. Callers MUST pass
    every field: defaults (and default factories) are not applied."""
    new = cls.__new__(cls)
    new.__dict__.update(fields)
    return new


def frozen_replace(obj, **changes):
    """:func:`fast_replace`, born frozen — commit-time ``freeze`` stops at
    one dict probe instead of re-walking every field.

    Contract (caller-audited, like :func:`frozen_new`): ``obj`` is
    already frozen, and every changed value is either a scalar or
    already-frozen (a ``FrozenDict``/``FrozenList``, a frozen instance).
    The write paths use this for the STATUS/SPEC children of replacement
    objects — never for ``meta``, which the store must mutate (resource
    version bump) at commit time."""
    cls = obj.__class__
    new = cls.__new__(cls)
    d = new.__dict__
    d.update(obj.__dict__)
    d.update(changes)
    d[FROZEN_FLAG] = True
    return new


def frozen_new(cls, **fields):
    """:func:`fast_new`, born frozen — for SCALAR-ONLY dataclasses.

    The mass-decoded rows (``JobInfo``, ``SubjobStatus``,
    ``ContainerStatus``) hold nothing but strings/ints/enums/datetimes,
    so commit-time ``freeze`` has no recursive work to do on them; the
    walk itself (one dispatch per field × 45k rows × 18 fields per
    mirror tick) was pure overhead. Marking them frozen at birth lets
    ``freeze`` short-circuit at one dict probe per row. The class guard
    is installed first, so these instances reject mutation exactly like
    store snapshots — do NOT use this for types with dict/list/dataclass
    fields (they would be shared un-frozen).
    """
    if not cls.__dict__.get(PATCHED_FLAG, False):
        enable_guard(cls)
    new = cls.__new__(cls)
    d = new.__dict__
    d.update(fields)
    d[FROZEN_FLAG] = True
    return new
