"""Typed hierarchical configuration — the reference's ParametersHandler layer.

Accelerator-native re-design of the reference's configuration stack
(``src/ParametersHandler/include/BipedalLocomotion/ParametersHandler/IParametersHandler.h:26-249``,
``StdImplementation.h:27-236``, YARP ``.ini`` backend
``YarpImplementation.cpp:110-197``): a backend-agnostic typed key/value store with
hierarchical named groups, used by every component's ``initialize()`` protocol
(reference call stack SURVEY.md §3.5).

Semantics preserved from the reference:

- typed get of int / float / bool / str and homogeneous vectors thereof
  (``IParametersHandler.h:131-139``);
- a *missing key is an explicit error* (``StdImplementation.tpp:23-29`` returns
  ``false``; here, host-side, we raise ``KeyError`` per SURVEY.md §7's
  "bool + cerr → exceptions on host" mapping);
- a *type mismatch is an explicit error* (``std::any_cast`` failure →
  ``TypeError``);
- groups are **shared by reference**: ``get_group`` returns the live child
  handler stored in the parent, so writes through the child are visible to the
  parent (``StdImplementation.cpp:111-144`` stores ``shared_ptr`` handlers);
- ``clear()``, ``is_empty()``, ``to_string()`` round-trips
  (``StdImplementation.cpp:146-169``).

File backends:

- :func:`IniHandler.from_file` parses the YARP-style ``.ini`` dialect used by the
  reference's fixtures (``src/Estimators/tests/config.ini``,
  ``src/ParametersHandler/tests/config.ini``): ``key value`` lines, quoted keys,
  parenthesised lists, and ``[GROUP]`` sections that become child handlers
  (mirroring ``YarpImplementation.cpp:115-144``).
- :func:`TomlHandler.from_file` maps TOML tables to nested groups.

There is deliberately no JAX in this module: configuration is host-side and
feeds static (weight-level) parameters into jitted functions.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "ParametersHandler",
    "StdHandler",
    "IniHandler",
    "TomlHandler",
    "parse_ini",
]


def _is_scalar(v: Any) -> bool:
    return isinstance(v, (bool, int, float, str, np.bool_, np.integer, np.floating))


class ParametersHandler:
    """Backend-agnostic typed parameter store with named groups.

    Equivalent of ``IParametersHandler`` (``IParametersHandler.h:26-249``): the
    dict backend *is* the base class in Python — file backends construct one.
    """

    def __init__(self, data: Mapping[str, Any] | None = None):
        self._params: dict[str, Any] = {}
        self._groups: dict[str, "ParametersHandler"] = {}
        if data:
            self.update(data)

    # -- set -----------------------------------------------------------------
    def set_parameter(self, name: str, value: Any) -> None:
        """Set a scalar/string/vector parameter (``IParametersHandler.h:178-199``)."""
        if isinstance(value, ParametersHandler):
            raise TypeError("use set_group() for nested handlers")
        if isinstance(value, np.ndarray):
            value = value.tolist()
        elif isinstance(value, tuple):
            value = list(value)
        self._params[name] = value

    def update(self, data: Mapping[str, Any]) -> None:
        """Bulk-set from a mapping; nested mappings become groups
        (equivalent of ``StdImplementation::set(object)``, ``StdImplementation.cpp:102-109``)."""
        for k, v in data.items():
            if isinstance(v, Mapping):
                self.set_group(k, ParametersHandler(v))
            elif isinstance(v, ParametersHandler):
                self.set_group(k, v)
            else:
                self.set_parameter(k, v)

    def set_group(self, name: str, handler: "ParametersHandler") -> None:
        """Attach a child handler, shared by reference (``StdImplementation.cpp:129-144``)."""
        if not isinstance(handler, ParametersHandler):
            raise TypeError(f"group {name!r} must be a ParametersHandler")
        self._groups[name] = handler

    # -- get -----------------------------------------------------------------
    def get_parameter(self, name: str, dtype: type | None = None) -> Any:
        """Typed get. Missing key raises ``KeyError``; a ``dtype`` enforces the
        reference's strict typing (``StdImplementation.tpp:20-105``):
        ``int``/``float``/``bool``/``str`` for scalars, ``list`` for any vector.

        As in YARP's numeric model (``YarpUtilities/Helper.cpp:38-56``),
        requesting ``float`` accepts an int (promotion), but requesting ``int``
        for a non-integral float is an error.
        """
        if name not in self._params:
            raise KeyError(
                f"[ParametersHandler::get_parameter] parameter {name!r} not found"
            )
        value = self._params[name]
        if dtype is None:
            return value
        return _coerce(name, value, dtype)

    def get_vector(self, name: str, dtype: type | None = None) -> list:
        """Get a homogeneous vector (``IParametersHandler.h:131-139``)."""
        value = self.get_parameter(name)
        if _is_scalar(value):
            raise TypeError(
                f"[ParametersHandler::get_vector] parameter {name!r} is a scalar"
            )
        seq = list(value)
        if dtype is not None:
            seq = [_coerce(f"{name}[{i}]", v, dtype) for i, v in enumerate(seq)]
        return seq

    def get_array(self, name: str, dtype=np.float64) -> np.ndarray:
        """Vector as a NumPy array — device-feeding convenience."""
        return np.asarray(self.get_vector(name), dtype=dtype)

    def get_group(self, name: str) -> "ParametersHandler":
        """Live (shared) child handler; missing group raises ``KeyError``
        (``StdImplementation.cpp:111-127`` returns an expired weak_ptr)."""
        if name not in self._groups:
            raise KeyError(
                f"[ParametersHandler::get_group] group {name!r} not found"
            )
        return self._groups[name]

    def has_parameter(self, name: str) -> bool:
        return name in self._params

    def has_group(self, name: str) -> bool:
        return name in self._groups

    def group_names(self) -> list[str]:
        return list(self._groups)

    def parameter_names(self) -> list[str]:
        return list(self._params)

    # -- lifecycle -----------------------------------------------------------
    def clear(self) -> None:
        """Drop all parameters and groups (``StdImplementation.cpp:157-162``)."""
        self._params.clear()
        self._groups.clear()

    def is_empty(self) -> bool:
        """True iff no parameters and no groups (``StdImplementation.cpp:164-169``)."""
        return not self._params and not self._groups

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = dict(self._params)
        for k, g in self._groups.items():
            out[k] = g.to_dict()
        return out

    def to_string(self) -> str:
        """Human-readable dump (``StdImplementation.cpp:146-155``)."""
        parts = [f"{k} {v}" for k, v in self._params.items()]
        parts += [f"[{k}] {{{g.to_string()}}}" for k, g in self._groups.items()]
        return " ".join(parts)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.to_dict()!r})"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ParametersHandler):
            return NotImplemented
        return self.to_dict() == other.to_dict()


#: Dict backend alias — the equivalent of ``StdImplementation``.
StdHandler = ParametersHandler


def _coerce(name: str, value: Any, dtype: type) -> Any:
    """Strict-but-promoting scalar coercion mirroring the reference's typing rules."""
    if dtype is list:
        if _is_scalar(value):
            raise TypeError(f"parameter {name!r} is scalar, vector requested")
        return list(value)
    if dtype is bool:
        if isinstance(value, (bool, np.bool_)):
            return bool(value)
        raise TypeError(f"parameter {name!r} has type {type(value).__name__}, bool requested")
    if dtype is int:
        if isinstance(value, (bool, np.bool_)):
            raise TypeError(f"parameter {name!r} is bool, int requested")
        if isinstance(value, (int, np.integer)):
            return int(value)
        if isinstance(value, (float, np.floating)) and float(value).is_integer():
            return int(value)
        raise TypeError(f"parameter {name!r} has type {type(value).__name__}, int requested")
    if dtype is float:
        if isinstance(value, (bool, np.bool_)):
            raise TypeError(f"parameter {name!r} is bool, float requested")
        if isinstance(value, (int, float, np.integer, np.floating)):
            return float(value)
        raise TypeError(f"parameter {name!r} has type {type(value).__name__}, float requested")
    if dtype is str:
        if isinstance(value, str):
            return value
        raise TypeError(f"parameter {name!r} has type {type(value).__name__}, str requested")
    raise TypeError(f"unsupported requested dtype {dtype!r} for parameter {name!r}")


# ---------------------------------------------------------------------------
# YARP-style .ini backend
# ---------------------------------------------------------------------------

def _parse_token(tok: str) -> Any:
    """One ini token → bool | int | float | str (YARP ``Value`` semantics,
    consumed via ``YarpUtilities::convertValue`` specialisations, ``Helper.cpp:38-56``)."""
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1]
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        f = float(tok)
        if math.isfinite(f):
            return f
    except ValueError:
        pass
    return tok


def _tokenize_ini_line(line: str) -> list[str]:
    """Split a line into tokens, honouring double quotes and ``( … )`` lists.

    Returns raw tokens; ``(`` and ``)`` are their own tokens.
    """
    toks: list[str] = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c.isspace() or c == ",":
            i += 1
        elif c in "()":
            toks.append(c)
            i += 1
        elif c == '"':
            j = i + 1
            while j < n and line[j] != '"':
                j += 1
            toks.append(line[i : j + 1])
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace() and line[j] not in '(),"':
                j += 1
            toks.append(line[i:j])
            i = j
    return toks


def parse_ini(text: str) -> dict[str, Any]:
    """Parse the YARP ``.ini`` dialect used by the reference fixtures.

    Supported grammar (all the constructs appearing in
    ``src/Estimators/tests/config.ini`` and ``src/ParametersHandler/tests/config.ini``):
    ``key value`` pairs, quoted keys/values, parenthesised comma/space-separated
    lists, ``[GROUP]`` section headers (→ nested dict, as
    ``YarpImplementation::getGroup``/``set`` build child handlers from bottles,
    ``YarpImplementation.cpp:115-144``), ``//`` and ``#`` comments.
    """
    root: dict[str, Any] = {}
    current = root
    for raw in text.splitlines():
        line = raw.split("//")[0].strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("[") and line.endswith("]"):
            group = line[1:-1].strip()
            current = root.setdefault(group, {})
            continue
        toks = _tokenize_ini_line(line)
        if not toks:
            continue
        key = _parse_token(toks[0])
        if not isinstance(key, str):
            key = toks[0]
        rest = toks[1:]
        if not rest:
            current[key] = True
            continue
        if rest[0] == "(":
            vals = [_parse_token(t) for t in rest[1:] if t not in "()"]
            current[key] = vals
        elif len(rest) == 1:
            current[key] = _parse_token(rest[0])
        else:
            current[key] = [_parse_token(t) for t in rest]
    return root


class IniHandler(ParametersHandler):
    """ParametersHandler over a YARP-style ``.ini`` file — equivalent of
    ``ParametersHandlerYarpImplementation`` (``YarpImplementation.cpp:110-197``)."""

    @classmethod
    def from_file(cls, path) -> "IniHandler":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_string(f.read())

    @classmethod
    def from_string(cls, text: str) -> "IniHandler":
        return cls(parse_ini(text))


class TomlHandler(ParametersHandler):
    """ParametersHandler over a TOML file; tables become groups."""

    @classmethod
    def from_file(cls, path) -> "TomlHandler":
        import tomllib

        with open(path, "rb") as f:
            return cls(tomllib.load(f))

    @classmethod
    def from_string(cls, text: str) -> "TomlHandler":
        import tomllib

        return cls(tomllib.loads(text))
