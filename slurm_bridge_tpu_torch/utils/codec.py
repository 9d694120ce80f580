"""Config-file codec: YAML ↔ dataclasses with kubelet-style semantics.

Reference parity: the VK's config plumbing (SURVEY.md §2.5) —
- strict-then-lenient decoding (codec/codec.go:59-101): unknown fields are
  an error on the strict pass; the lenient fallback accepts them with a
  warning so an old binary can read a newer config file;
- defaulting: dataclass defaults play the role of the generated
  zz_generated.defaults.go setters;
- relative-path resolution against the config file's directory
  (configfiles.go:83-90);
- flag-over-file precedence (server.go:237-252): flags the user actually
  passed on the command line win over file values.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import types
import typing

log = logging.getLogger("sbt.codec")


class ConfigError(ValueError):
    pass


def _convert(value, ftype, path: str, *, strict: bool):
    origin = typing.get_origin(ftype)
    if dataclasses.is_dataclass(ftype):
        if isinstance(value, dict):
            return _decode_into(value, ftype, path, strict=strict)
        raise ConfigError(
            f"{path}: expected mapping for {ftype.__name__}, "
            f"got {type(value).__name__} {value!r}"
        )
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        (inner,) = typing.get_args(ftype)[:1] or (typing.Any,)
        seq = [
            _convert(v, inner, f"{path}[{i}]", strict=strict)
            for i, v in enumerate(value)
        ]
        return tuple(seq) if origin is tuple else seq
    if origin is dict and isinstance(value, dict):
        args = typing.get_args(ftype)
        vt = args[1] if len(args) == 2 else typing.Any
        return {
            str(k): _convert(v, vt, f"{path}.{k}", strict=strict)
            for k, v in value.items()
        }
    if origin is typing.Union or origin is types.UnionType:  # Optional[X] / X | None
        for arg in typing.get_args(ftype):
            if arg is type(None):
                if value is None:
                    return None
                continue
            try:
                return _convert(value, arg, path, strict=strict)
            except ConfigError:
                continue
        raise ConfigError(f"{path}: cannot convert {value!r} to {ftype}")
    if ftype in (int, float, str, bool):
        if isinstance(value, ftype) and not (ftype is int and isinstance(value, bool)):
            return value
        if ftype is float and isinstance(value, int):
            return float(value)
        if ftype is int and isinstance(value, bool):
            raise ConfigError(f"{path}: expected int, got bool {value!r}")
        if strict:
            raise ConfigError(
                f"{path}: expected {ftype.__name__}, got {type(value).__name__} {value!r}"
            )
        try:  # lenient: coerce ("10250" → 10250), as sigs.k8s.io/yaml would
            if ftype is bool:
                # bool("false") is True — parse the words instead
                s = str(value).strip().lower()
                if s in ("true", "yes", "on", "1"):
                    return True
                if s in ("false", "no", "off", "0"):
                    return False
                raise ValueError(s)
            return ftype(value)
        except (TypeError, ValueError):
            raise ConfigError(f"{path}: cannot coerce {value!r} to {ftype.__name__}") from None
    return value


def _decode_into(raw: dict, cls, path: str, *, strict: bool):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(raw) - set(fields)
    if unknown:
        msg = f"{path or cls.__name__}: unknown fields {sorted(unknown)}"
        if strict:
            raise ConfigError(msg)
        log.warning("%s (ignored by lenient decode)", msg)
    kwargs = {}
    for name, f in fields.items():
        if name not in raw:
            continue
        ftype = f.type if not isinstance(f.type, str) else typing.get_type_hints(cls)[name]
        kwargs[name] = _convert(raw[name], ftype, f"{path}.{name}" if path else name,
                                strict=strict)
    try:
        return cls(**kwargs)
    except TypeError as exc:  # missing required fields
        raise ConfigError(f"{path or cls.__name__}: {exc}") from None


def decode_yaml_config(text: str, cls):
    """YAML → dataclass, strict first, lenient on unknown-field failure."""
    import yaml

    raw = yaml.safe_load(text) or {}
    if not isinstance(raw, dict):
        raise ConfigError(f"config root must be a mapping, got {type(raw).__name__}")
    try:
        return _decode_into(raw, cls, "", strict=True)
    except ConfigError as strict_err:
        try:
            obj = _decode_into(raw, cls, "", strict=False)
        except ConfigError:
            raise strict_err from None
        log.warning("config decoded leniently after strict failure: %s", strict_err)
        return obj


def encode_yaml_config(obj) -> str:
    import yaml

    return yaml.safe_dump(dataclasses.asdict(obj), sort_keys=True)


def resolve_relative_paths(obj, base_dir: str, path_fields: tuple[str, ...]):
    """Resolve relative path fields against the config file's directory
    (configfiles.go:83-90). Returns a dataclasses.replace()'d copy."""
    updates = {}
    for name in path_fields:
        val = getattr(obj, name)
        if val and not os.path.isabs(val):
            updates[name] = os.path.normpath(os.path.join(base_dir, val))
    return dataclasses.replace(obj, **updates) if updates else obj


def explicit_flags(parser, argv) -> set[str]:
    """Dest names of flags the user actually passed — the precedence set
    for flag-over-file merging (server.go:237-252 re-parses for this).

    Unambiguous argparse prefix abbreviations (``--kubelet-por``) resolve to
    the same dest they would parse as, so a file value can never silently
    override an abbreviated-but-explicit flag.
    """
    passed: set[str] = set()
    opts = {s: a.dest for a in parser._actions for s in a.option_strings}
    for tok in argv:
        if not tok.startswith("-"):
            continue
        name = tok.split("=", 1)[0]
        if name in opts:
            passed.add(opts[name])
        elif name.startswith("--") and len(name) > 2:
            matches = {d for s, d in opts.items() if s.startswith(name)}
            if len(matches) == 1:  # what allow_abbrev would accept
                passed.add(matches.pop())
    return passed


def merge_flags_over_file(config, args, passed: set[str], mapping: dict[str, str]):
    """Overlay explicitly-passed flags onto a file-loaded config.

    ``mapping`` is flag-dest → config-field. Returns a replace()'d copy.
    """
    updates = {
        field: getattr(args, dest)
        for dest, field in mapping.items()
        if dest in passed
    }
    return dataclasses.replace(config, **updates) if updates else config
