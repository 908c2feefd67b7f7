"""A reader and a writer for the YAML subset of the repository's configs.

The card's machine is not known to have PyYAML, so the port reads and
writes its configs itself. The subset is what every file under configs/
uses:

* block mappings, nested by indentation (spaces only);
* comments, whole-line and trailing (a `#` at the start of a line or
  after a blank);
* flow sequences of scalars (`[0, 1, 2]`), and the empty flow mapping
  `{}`;
* plain scalars, and quoted scalars without escapes (`'a b'`, `"a b"`).

Anything else raises YAMLSubsetError naming the line: anchors, aliases,
tags, block scalars (`|`, `>`), block sequences (`- x`), quoted strings
with escapes, flow mappings other than `{}`, nested flow sequences,
multi-line scalars, document markers, directives and tabs.

Plain scalars resolve as PyYAML's `safe_load` resolves them (YAML 1.1):
the bool, int, float and null patterns below are copied from PyYAML
6.0.3's yaml/resolver.py, and the int, float and bool constructions from
its yaml/constructor.py (SafeConstructor.construct_yaml_*). So `1e-5` is
a string (the float pattern needs a dot and a signed exponent), `1.`,
`3.` and `1.6e-06` are floats, `yes` / `No` / `ON` are bools, `~`,
`null` and an empty value are None, and `1_000` is an int. Plain
scalars that PyYAML would read as timestamps, merge keys or `=` raise.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

# yaml/resolver.py (PyYAML 6.0.3), Resolver.add_implicit_resolver
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_OTHER_TAGS = re.compile(r"^(?:<<|=)$")
# characters that cannot start a plain scalar, with what they start
_INDICATORS = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
               ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
               "`": "a reserved indicator", "{": "a flow mapping", "}": "a flow mapping",
               "]": "a flow sequence's end", ",": "a flow separator", "?": "a complex key",
               "#": "a comment"}


class YAMLSubsetError(ValueError):
    """Input outside the subset this module reads, or malformed YAML."""


def _fail(where: str, line: int, what: str):
    raise YAMLSubsetError(f"{where}:{line}: {what} (outside the YAML subset the port reads)")


def _construct_int(value: str) -> int:
    # yaml/constructor.py SafeConstructor.construct_yaml_int
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else +1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        out, base = 0, 1
        for digit in reversed([int(p) for p in value.split(":")]):
            out, base = out + digit * base, base * 60
        return sign * out
    return sign * int(value)


def _construct_float(value: str) -> float:
    # yaml/constructor.py SafeConstructor.construct_yaml_float
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else +1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        out, base = 0.0, 1
        for digit in reversed([float(p) for p in value.split(":")]):
            out, base = out + digit * base, base * 60
        return sign * out
    return sign * float(value)


def resolve_plain(s: str, where: str = "<string>", line: int = 1) -> Any:
    """The value PyYAML's safe_load gives the plain scalar `s` (its
    patterns admit only the first characters PyYAML tries them on)."""
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _FLOAT.match(s):
        return _construct_float(s)
    if _INT.match(s):
        return _construct_int(s)
    if _NULL.match(s):
        return None
    if _TIMESTAMP.match(s) or _OTHER_TAGS.match(s):
        _fail(where, line, f"the plain scalar {s!r} resolves to a timestamp, merge key or value tag")
    return s


def _strip_comment(text: str) -> str:
    """The line without its comment: a `#` at the start or after a blank,
    outside a quoted scalar."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i]
    return text


def _quoted(s: str, where: str, line: int) -> Tuple[str, str]:
    """(the quoted scalar at the start of s, the rest of s)."""
    q = s[0]
    end = s.find(q, 1)
    if end < 0:
        _fail(where, line, "an unterminated or multi-line quoted scalar")
    body = s[1:end]
    if q == "'" and s[end + 1:end + 2] == "'":
        _fail(where, line, "a single-quoted scalar with an escaped quote")
    if q == '"' and "\\" in body:
        _fail(where, line, "a double-quoted scalar with escapes")
    return body, s[end + 1:]


def _scalar(s: str, where: str, line: int, flow: bool) -> Any:
    s = s.strip()
    if s[:1] in ("'", '"'):
        body, rest = _quoted(s, where, line)
        if rest.strip():
            _fail(where, line, f"text after a quoted scalar: {rest.strip()!r}")
        return body
    if s[:1] in _INDICATORS:
        _fail(where, line, f"{_INDICATORS[s[0]]} ({s!r})")
    if s[:2] in ("- ", "? ", ": ") or s in ("-", "?", ":"):
        _fail(where, line, f"a block indicator in {s!r}")
    if ": " in s or s.endswith(":"):
        _fail(where, line, f"a mapping inside a value ({s!r})")
    if flow and any(c in s for c in "[]{},"):
        _fail(where, line, f"a flow indicator inside the flow scalar {s!r}")
    return resolve_plain(s, where, line)


def _value(s: str, where: str, line: int) -> Any:
    """A mapping value or a whole one-line document: a flow sequence of
    scalars, `{}`, or a scalar."""
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            _fail(where, line, "a flow sequence that does not end on its line")
        inner = s[1:-1].strip()
        if not inner:
            return []
        if any(c in inner for c in "[]{}"):
            _fail(where, line, "a nested flow collection")
        out = []
        for item in _split_flow(inner, where, line):
            if not item.strip():
                _fail(where, line, "an empty flow sequence entry")
            out.append(_scalar(item, where, line, flow=True))
        return out
    if s.startswith("{"):
        if s.replace(" ", "") != "{}":
            _fail(where, line, "a flow mapping")
        return {}
    return _scalar(s, where, line, flow=False)


def _split_flow(inner: str, where: str, line: int) -> List[str]:
    """Split a flow sequence's body at the commas outside quotes."""
    items, cur, quote = [], "", None
    for ch in inner:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and not cur.strip():
            quote = ch
        elif ch == ",":
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if quote:
        _fail(where, line, "an unterminated quoted scalar")
    items.append(cur)
    return items


def _key_and_rest(content: str, where: str, line: int):
    """(key, rest) of a `key: value` line, or None when the line is no
    mapping entry."""
    if content[:1] in ("'", '"'):
        key, rest = _quoted(content, where, line)
        if not (rest.startswith(": ") or rest == ":"):
            return None
        return key, rest[1:]
    m = re.search(r":( |$)", content)
    if m is None:
        return None
    key = content[:m.start()]
    if not key.strip():
        _fail(where, line, "an empty key")
    return _scalar(key, where, line, flow=False), content[m.end():]


def loads(text: str, where: str = "<string>") -> Any:
    """The document in `text`, as PyYAML's safe_load reads it: a dict, a
    list, a scalar, or None for an empty document."""
    rows = []  # (line number, indent, content)
    for n, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw:
            _fail(where, n, "a tab")
        content = _strip_comment(raw).rstrip()
        if not content.strip():
            continue
        stripped = content.lstrip(" ")
        if stripped.startswith(("%", "--- ", "... ")) or stripped in ("---", "..."):
            _fail(where, n, f"a document marker or directive ({stripped!r})")
        rows.append((n, len(content) - len(stripped), stripped))
    if not rows:
        return None
    n0, ind0, c0 = rows[0]
    if _key_and_rest(c0, where, n0) is None and not c0.startswith(("- ", "? ")) and c0 not in ("-", "?"):
        if len(rows) > 1:
            _fail(where, rows[1][0], "a multi-line scalar")
        return _value(c0, where, n0)
    out, i = _block(rows, 0, ind0, where)
    if i < len(rows):
        _fail(where, rows[i][0], "a line indented less than the document")
    return out


def _block(rows, i: int, indent: int, where: str):
    out = {}
    while i < len(rows):
        n, ind, content = rows[i]
        if ind < indent:
            break
        if ind > indent:
            _fail(where, n, "unexpected indentation (a multi-line scalar?)")
        if content.startswith(("- ", "? ")) or content in ("-", "?"):
            _fail(where, n, "a block sequence or complex key")
        kv = _key_and_rest(content, where, n)
        if kv is None:
            _fail(where, n, f"a line that is no `key: value` entry ({content!r})")
        key, rest = kv
        i += 1
        if rest.strip():
            out[key] = _value(rest, where, n)
        elif i < len(rows) and rows[i][1] > indent:
            out[key], i = _block(rows, i, rows[i][1], where)
        else:
            out[key] = None
    return out, i


def load_file(path: str) -> Any:
    with open(path) as f:
        return loads(f.read(), where=path)


# ---------------------------------------------------------------- writer


def _plain_ok(s: str, flow: bool) -> bool:
    if not s or s != s.strip() or any(ord(c) < 32 or c == "\x7f" for c in s):
        return False
    if s[0] in _INDICATORS or s[0] in "-:'\"[" or ": " in s or " #" in s or s.endswith(":"):
        return False
    if flow and any(c in s for c in "[]{},"):
        return False
    try:
        return isinstance(resolve_plain(s), str)
    except YAMLSubsetError:  # a timestamp
        return False


def _dump_scalar(v: Any, flow: bool = False) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        # yaml/representer.py SafeRepresenter.represent_float
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        if _plain_ok(v, flow):
            return v
        if any(ord(c) < 32 for c in v):
            raise ValueError(f"cannot write the string {v!r} in the YAML subset")
        if "'" not in v:
            return f"'{v}'"
        if '"' not in v and "\\" not in v:
            return f'"{v}"'
        raise ValueError(f"cannot write the string {v!r} in the YAML subset")
    raise ValueError(f"cannot write a {type(v).__name__} in the YAML subset")


def dumps(d: dict) -> str:
    """`d` as block-style YAML of the subset (keys sorted, as PyYAML's
    safe_dump sorts them; lists of scalars in flow style)."""
    lines: List[str] = []

    def emit(m: dict, indent: int):
        for k in sorted(m, key=str):
            v = m[k]
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                lines.append(f"{' ' * indent}{key}:")
                emit(v, indent + 2)
            elif isinstance(v, dict):
                lines.append(f"{' ' * indent}{key}: {{}}")
            elif isinstance(v, (list, tuple)):
                if any(isinstance(x, (dict, list, tuple)) for x in v):
                    raise ValueError(f"cannot write the nested list {k}: {v!r} in the YAML subset")
                lines.append(f"{' ' * indent}{key}: [{', '.join(_dump_scalar(x, flow=True) for x in v)}]")
            else:
                lines.append(f"{' ' * indent}{key}: {_dump_scalar(v)}")

    emit(d, 0)
    return "\n".join(lines) + "\n"
