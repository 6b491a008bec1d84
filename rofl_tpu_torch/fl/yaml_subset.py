"""A reader for the subset of YAML that the experiment files use
(``configs/*.yml``), so that the port needs no ``yaml`` package.

The subset: block mappings nested by indentation (spaces only), plain keys,
and scalar values: plain scalars resolved as PyYAML's ``safe_load`` resolves
them (YAML 1.1 null, bool, int with its 0b / 0 / 0x forms and underscores,
float with ``.inf`` / ``.nan``, else a string), single- and double-quoted
strings on one line, ``#`` comments on their own line or after a value, blank
lines and one leading ``---``. A key with no value and no deeper lines under
it is null.

Anything else raises ``YamlSubsetError`` rather than being guessed at: flow
collections (``[``, ``{``), block sequences (``- ``), anchors, aliases and
tags (``&``, ``*``, ``!``), block scalars (``|``, ``>``), directives, tabs,
a second document, quoted or complex keys, multi-line scalars, sexagesimal
numbers and timestamps.
"""

from __future__ import annotations

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_UNSUPPORTED_START = set("[]{}&*!|>%@`,?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YamlSubsetError(ValueError):
    """The text is outside the subset this reader accepts."""


def _fail(lineno: int, why: str):
    raise YamlSubsetError(f"line {lineno}: {why}")


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
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
    return sign * int(value)


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * float(value)


def resolve_plain(text: str, lineno: int = 0):
    """A plain scalar as ``safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _SEXAGESIMAL.match(text) or _TIMESTAMP.match(text) or text in ("<<", "="):
        _fail(lineno, f"{text!r}: sexagesimal numbers, timestamps, merge keys and value "
                      "keys are outside the subset")
    return text


def _double_quoted(body: str, lineno: int) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == '"':
            _fail(lineno, "text after a closing double quote")
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        if i + 1 >= len(body):
            _fail(lineno, "a backslash at the end of a double-quoted string")
        esc = body[i + 1]
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            digits = body[i + 2:i + 2 + n]
            if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                _fail(lineno, f"bad \\{esc} escape")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            _fail(lineno, f"unknown escape \\{esc}")
    return "".join(out)


def _after_quote(rest: str, lineno: int) -> None:
    rest = rest.lstrip(" ")
    if rest and not rest.startswith("#"):
        _fail(lineno, "text after a quoted string")


def parse_value(text: str, lineno: int = 0):
    """A value on the rest of a ``key:`` line (its comment still on)."""
    text = text.strip(" ")
    if text.startswith("'"):
        m = re.match(r"'((?:[^']|'')*)'", text)
        if not m:
            _fail(lineno, "an unterminated single-quoted string")
        _after_quote(text[m.end():], lineno)
        return m.group(1).replace("''", "'")
    if text.startswith('"'):
        m = re.match(r'"((?:[^"\\]|\\.)*)"', text)
        if not m:
            _fail(lineno, "an unterminated double-quoted string")
        _after_quote(text[m.end():], lineno)
        return _double_quoted(m.group(1), lineno)
    m = re.search(r"(^|\s)#", text)
    if m:
        text = text[:m.start()].rstrip(" ")
    if text and (text[0] in _UNSUPPORTED_START or text.startswith("- ") or text == "-"):
        _fail(lineno, f"{text!r}: flow collections, sequences, anchors, aliases, tags and "
                      "block scalars are outside the subset")
    if ": " in text or text.endswith(":"):
        _fail(lineno, f"{text!r}: a mapping is not allowed as an inline value")
    if " #" in text or "\t" in text:
        _fail(lineno, f"{text!r}: outside the subset")
    return resolve_plain(text, lineno)


def _lines(text: str):
    """(lineno, indent, content) of each line that holds more than a comment."""
    seen_content = False
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            _fail(lineno, "tabs are outside the subset")
        stripped = raw.strip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("%"):
            _fail(lineno, "directives are outside the subset")
        if re.match(r"^(---|\.\.\.)(\s|$)", raw):
            if raw.startswith("---") and not seen_content and stripped == "---":
                seen_content = True  # one leading document marker
                continue
            _fail(lineno, "a second document, or a document end, is outside the subset")
        seen_content = True
        yield lineno, len(raw) - len(raw.lstrip(" ")), raw.strip(" ")


_KEY = re.compile(r"^([^\s#'\"][^:#]*?)\s*:(?:\s+(.*))?$|^([^\s#'\"][^:#]*?)\s*:$")


def safe_load(text: str):
    """The mapping of `text` (None for a document with nothing in it), as
    ``yaml.safe_load`` gives it for the subset; ``YamlSubsetError`` for
    anything outside."""
    lines = list(_lines(text))
    if not lines:
        return None
    root, pos = _mapping(lines, 0, lines[0][1])
    if pos != len(lines):
        lineno, indent, _ = lines[pos]
        _fail(lineno, f"indentation {indent} does not continue any mapping")
    return root


def _mapping(lines, pos: int, indent: int):
    out = {}
    while pos < len(lines):
        lineno, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            _fail(lineno, f"unexpected indentation {ind} (the mapping is at {indent})")
        if content[0] in _UNSUPPORTED_START or content.startswith("- ") or content == "-":
            _fail(lineno, f"{content!r}: only block mappings with plain keys are in the subset")
        m = _KEY.match(content)
        if not m:
            _fail(lineno, f"{content!r} is not 'key: value'")
        key_text = m.group(1) if m.group(1) is not None else m.group(3)
        key = resolve_plain(key_text, lineno)
        rest = m.group(2) if m.group(1) is not None else None
        pos += 1
        if rest is not None and rest.strip() and not rest.strip().startswith("#"):
            value = parse_value(rest, lineno)
        elif pos < len(lines) and lines[pos][1] > indent:
            value, pos = _mapping(lines, pos, lines[pos][1])
        else:
            value = None
        out[key] = value
    return out, pos
