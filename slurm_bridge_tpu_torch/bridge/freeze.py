"""Recursive freezing for store-held objects — the copy-on-read seam.

The :class:`ObjectStore` used to ``copy.deepcopy`` every object on every
``get``/``list``; at the paper's headline shape that is ~100k deep copies
per provider per tick and the single largest cost in the reconcile loop
(BASELINE.md PR-2: store phase 14.3 s of a 121.6 s tick). The rework
instead freezes each object ONCE when it is written and hands out the
stored reference on every read:

- reads share references — zero copies, safe because a frozen object
  rejects mutation loudly (:class:`FrozenInstanceError`) instead of
  silently corrupting the store;
- writers get a private thawed copy via :func:`thaw` (``copy.deepcopy``
  — the freeze types unfreeze themselves on deepcopy), mutate it, and
  hand ownership back to the store, which freezes it in place;
- frozen sub-objects (an unchanged ``spec.demand``, a labels dict) can be
  structurally shared between versions by writers that build replacement
  objects with :func:`dataclasses.replace` — immutability makes the
  sharing safe.

Freezing is type-driven and class-patching: the first time a dataclass
type passes through :func:`freeze`, its ``__setattr__`` gains the frozen
guard and its ``__deepcopy__`` the thaw-on-copy behavior (idempotent, a
dict lookup per setattr otherwise). Plain ``dict``/``list`` fields are
wrapped in :class:`FrozenDict`/:class:`FrozenList`, which compare equal
to their plain counterparts and deep-copy back to them.
"""

from __future__ import annotations

import copy
import dataclasses

from slurm_bridge_tpu_torch.core.fastpath import (  # noqa: F401  (re-exported)
    FROZEN_FLAG,
    FrozenInstanceError,
    enable_guard as _enable,
    fast_new,
    fast_replace,
    frozen_new,
    frozen_replace,
)


def _blocked(self, *a, **k):
    raise FrozenInstanceError(
        f"{type(self).__name__} belongs to a frozen store snapshot"
    )


class FrozenDict(dict):
    """A dict that rejects mutation; deep-copies back to a plain dict."""

    __setitem__ = __delitem__ = _blocked
    pop = popitem = clear = update = setdefault = _blocked
    __ior__ = _blocked

    def __deepcopy__(self, memo):
        return {
            copy.deepcopy(k, memo): copy.deepcopy(v, memo)
            for k, v in self.items()
        }

    def __reduce_ex__(self, protocol):  # pickle as a plain dict
        return (dict, (dict(self),))


class FrozenList(list):
    """A list that rejects mutation; deep-copies back to a plain list."""

    __setitem__ = __delitem__ = _blocked
    append = extend = insert = remove = pop = clear = _blocked
    sort = reverse = __iadd__ = __imul__ = _blocked

    def __deepcopy__(self, memo):
        return [copy.deepcopy(v, memo) for v in self]

    def __reduce_ex__(self, protocol):  # pickle as a plain list
        return (list, (list(self),))


def is_frozen(obj) -> bool:
    d = getattr(obj, "__dict__", None)
    return bool(d) and d.get(FROZEN_FLAG, False)


#: per-type dispatch cache — freeze() runs once per field of every store
#: write, so the classification (scalar / dataclass / container) must be
#: one dict lookup, not an is_dataclass()+fields() walk each time
_K_SCALAR, _K_DATACLASS, _K_DICT, _K_LIST, _K_TUPLE = range(5)
_kind_of: dict[type, int] = {}
_field_names: dict[type, tuple[str, ...]] = {}


def _classify(t: type) -> int:
    if t is dict:
        k = _K_DICT
    elif t is list:
        k = _K_LIST
    elif t is tuple:
        k = _K_TUPLE
    elif dataclasses.is_dataclass(t):
        _enable(t)
        _field_names[t] = tuple(f.name for f in dataclasses.fields(t))
        k = _K_DATACLASS
    else:
        # scalars, enums, datetimes, FrozenDict/FrozenList (already
        # frozen), frozen dataclasses: nothing to do, ever
        k = _K_SCALAR
    _kind_of[t] = k
    return k


def freeze(obj):
    """Deep-freeze a dataclass graph in place (the store takes ownership).

    Returns the same object. Dict/list fields are replaced by their
    frozen wrappers; nested dataclasses are frozen recursively. Already-
    frozen sub-objects short-circuit, so re-freezing a replacement object
    that structurally shares frozen children is cheap.
    """
    t = obj.__class__
    k = _kind_of.get(t)
    if k is None:
        k = _classify(t)
    if k == _K_SCALAR:
        return obj
    if k == _K_DATACLASS:
        d = obj.__dict__
        if d.get(FROZEN_FLAG, False):
            return obj
        for name in _field_names[t]:
            fv = d.get(name)
            nv = freeze(fv)
            if nv is not fv:
                d[name] = nv
        d[FROZEN_FLAG] = True
        return obj
    if k == _K_DICT:
        return FrozenDict((key, freeze(v)) for key, v in obj.items())
    if k == _K_LIST:
        return FrozenList(freeze(v) for v in obj)
    items = [freeze(v) for v in obj]  # tuple
    if any(a is not b for a, b in zip(items, obj)):
        return tuple(items)
    return obj


def thaw(obj):
    """A private, fully-mutable deep copy of a (frozen) object graph."""
    return copy.deepcopy(obj)
