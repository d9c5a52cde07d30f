"""A reader of the YAML that config files use, with no PyYAML.

`safe_load(text_or_stream)` returns the tree `yaml.safe_load` returns for
the subset of YAML that configs are written in:
  * block mappings and sequences (nested, compact `- key: value` items,
    sequences at their key's indent), comments, blank lines, one leading
    `---`;
  * plain, single- and double-quoted scalars, on one line or folded over
    several; plain ones typed by YAML 1.1's rules as PyYAML resolves
    them: null (`~`, `null`, empty), booleans (`yes`/`no`/`on`/`off`/
    `true`/`false` in three cases), ints (decimal, `0b`, `0x`, leading-0
    octal, `_` separators, base 60) and floats (a `.` required, `.inf`,
    `.nan`, base 60); keys are typed the same way;
  * flow mappings and sequences (`{dense: 1.0, bm25: 0.6}`, `[a, b]`),
    nested, over several lines.
Anything else raises ValueError naming the line: anchors and aliases,
tags, block scalars (`|`, `>`), complex keys, merge keys, timestamps,
directives, a second document, tabs outside quotes. It never returns a
tree that differs from PyYAML's.

`safe_dump(tree)` writes such a tree back (block style, keys in their
order, strings double-quoted where a plain scalar would read otherwise):
both safe_load and yaml.safe_load read its text as the tree.
"""
from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# double-quoted escapes (YAML 1.1, as PyYAML reads them)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# what may follow a ':' (or '-', '?') that ends a plain scalar in a flow
_FLOW_END = ("", " ", ",", "[", "]", "{", "}")
# characters that cannot open a plain scalar
_NOT_PLAIN = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
              ">": "block scalars", "%": "directives", "@": "reserved indicators",
              "`": "reserved indicators"}


def _base60(text: str, cast) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _to_int(text: str) -> int:
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
    if ":" in value:
        return sign * _base60(value, int)
    return sign * int(value)


def _to_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _base60(value, float)
    return sign * float(value)


def _is_dash(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _is_marker(line: str) -> bool:
    """A document start or end marker."""
    return line[:3] in ("---", "...") and (len(line) == 3 or line[3] in " \t")


class _Reader:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        self.lines: List[str] = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        self.i = 0

    def fail(self, what: str, line: int = -1) -> None:
        raise ValueError(f"YAML line {(self.i if line < 0 else line) + 1}: {what} "
                         "(outside the subset this reader takes)")

    # ------------------------------------------------------------ lines
    def _blank(self, i: int) -> bool:
        s = self.lines[i].strip()
        return not s or s[0] == "#"

    def _next(self) -> int:
        """Moves past blank and comment lines: the next line's indent, or
        -1 at the end."""
        while self.i < len(self.lines) and self._blank(self.i):
            self.i += 1
        if self.i == len(self.lines):
            return -1
        line = self.lines[self.i]
        n = len(line) - len(line.lstrip(" "))
        if line[n] == "\t":
            self.fail("a tab in the indentation")
        if _is_marker(line):
            self.fail("a second document or a document end marker")
        return n

    def _rest_is_blank(self, i: int, j: int) -> None:
        rest = self.lines[i][j:]
        s = rest.lstrip(" ")
        if s and s[0] != "#":
            self.fail(f"content after a quoted scalar or flow collection: {s!r}", i)

    # ------------------------------------------------------------ document
    def document(self) -> Any:
        n = self._next_first()
        if n < 0:
            return None
        value = self.block(n, -1)
        if self._next() >= 0:
            self.fail("content after the document's root node")
        return value

    def _next_first(self) -> int:
        while self.i < len(self.lines) and self._blank(self.i):
            self.i += 1
        if self.i == len(self.lines):
            return -1
        line = self.lines[self.i]
        if line.startswith("%"):
            self.fail("directives")
        if line[:3] == "---" and (len(line) == 3 or line[3] == " "):
            rest = line[3:].strip()
            if rest and rest[0] != "#":
                self.fail("content on the --- line")
            self.i += 1
        return self._next()

    # ------------------------------------------------------------ blocks
    def block(self, n: int, parent: int) -> Any:
        """The node that starts at column n of the current line."""
        text = self.lines[self.i][n:]
        if _is_dash(text):
            return self.sequence(n)
        if self._key(n) is not None:
            return self.mapping(n)
        return self.inline(n, parent)

    def _key(self, col: int):
        """(key, offset just past its ':' from col) when the current line
        opens a `key: value` entry at column col, else None."""
        line = self.lines[self.i]
        text = line[col:]
        if text[0] in "'\"":
            key, (i, k) = self.quoted(self.i, col, stay=True)
            if i != self.i:
                return None
            while k < len(line) and line[k] == " ":
                k += 1
            if line[k:k + 1] == ":" and (k + 1 == len(line) or line[k + 1] in " \t"):
                return key, k + 1 - col
            return None
        if text[0] in "[{":
            return None
        if text[0] == "?" and (len(text) == 1 or text[1] == " "):
            self.fail("complex keys (?)")
        j = 0
        while True:
            j = text.find(":", j)
            if j < 0:
                return None
            if j + 1 == len(text) or text[j + 1] in " \t":
                break
            j += 1
        comment = text.find(" #")
        if 0 <= comment < j:
            return None
        raw = text[:j].rstrip(" ")
        if not raw:
            self.fail("an empty key")
        if raw == "<<":
            self.fail("merge keys (<<)")
        self._check_plain_start(text, 0)
        return self.plain(raw), j + 1

    def mapping(self, n: int) -> dict:
        out: dict = {}
        while True:
            m = self._next()
            if m < n:
                return out
            if m > n:
                self.fail("a line indented deeper than its mapping's keys")
            text = self.lines[self.i][n:]
            kv = None if _is_dash(text) else self._key(n)
            if kv is None:
                self.fail("expected a `key: value` line")
            key, off = kv
            out[key] = self.value(n, n + off)

    def value(self, n: int, col: int, item: bool = False) -> Any:
        """The value whose key (or dash, for an item) sits at indent n; its
        text starts at column col of the current line or on the next."""
        rest = self.lines[self.i][col:]
        s = rest.lstrip(" ")
        if s.startswith("\t"):
            self.fail("a tab after ':' or '-'")
        if s and s[0] != "#":
            return self.inline(col + len(rest) - len(s), n)
        self.i += 1
        m = self._next()
        if m > n:
            return self.block(m, n)
        if m == n and not item and _is_dash(self.lines[self.i][n:]):
            return self.sequence(n)
        return None

    def sequence(self, n: int) -> list:
        out: list = []
        while True:
            m = self._next()
            if m < n:
                return out
            text = self.lines[self.i][n:]
            if m > n:
                self.fail("a line indented deeper than its sequence's dashes")
            if not _is_dash(text):
                return out
            rest = text[1:]
            s = rest.lstrip(" ")
            if not s or s[0] == "#":
                out.append(self.value(n, n + 1, item=True))
                continue
            if s[0] == "\t":
                self.fail("a tab after '-'")
            col = n + 1 + len(rest) - len(s)
            if _is_dash(s) or self._key(col) is not None:
                # a compact nested sequence or mapping starting at col
                self.lines[self.i] = " " * col + s
                out.append(self.block(col, n))
            else:
                out.append(self.inline(col, n))

    # ------------------------------------------------------------ scalars
    def inline(self, col: int, parent: int) -> Any:
        """A scalar or flow collection at column col of the current line;
        a plain scalar folds in the lines below it indented deeper than
        `parent`."""
        line = self.lines[self.i]
        c = line[col]
        if c in "[{":
            value, (i, j) = self.flow(self.i, col)
            self._rest_is_blank(i, j)
            self.i = i + 1
            return value
        if c in "'\"":
            value, (i, j) = self.quoted(self.i, col)
            self._rest_is_blank(i, j)
            self.i = i + 1
            return value
        self._check_plain_start(line, col)
        start = self.i
        text, ended = self._cut_comment(line[col:])
        first = text.rstrip(" ")
        parts = [first]
        self._check_plain_block(first)
        self.i += 1
        breaks = 0
        while not ended and self.i < len(self.lines):
            ln = self.lines[self.i]
            s = ln.strip(" ")
            if not s:
                breaks += 1
                self.i += 1
                continue
            ind = len(ln) - len(ln.lstrip(" "))
            if ind <= parent or s[0] == "#":
                break
            if _is_marker(ln):
                self.fail("a document marker inside a plain scalar")
            chunk, ended = self._cut_comment(s)
            chunk = chunk.rstrip(" ")
            self._check_plain_block(chunk)
            parts.append(("\n" * breaks if breaks else " ") + chunk)
            breaks = 0
            self.i += 1
        return self.plain("".join(parts), start)

    @staticmethod
    def _cut_comment(text: str) -> Tuple[str, bool]:
        k = text.find(" #")
        return (text, False) if k < 0 else (text[:k], True)

    def _check_plain_start(self, line: str, col: int) -> None:
        c = line[col]
        if c in _NOT_PLAIN:
            self.fail(_NOT_PLAIN[c])
        nxt = line[col + 1:col + 2]
        if c in ",]}" or (c in "-?:" and nxt in ("", " ")):
            self.fail(f"a value that opens with {c!r}")

    def _check_plain_block(self, text: str) -> None:
        if "\t" in text:
            self.fail("a tab in a plain scalar")
        if ": " in text or text.endswith(":"):
            self.fail("a ': ' inside a plain value (a wrongly indented key?)")

    def plain(self, text: str, line: int = -1) -> Any:
        """A plain scalar (from `line`) typed as YAML 1.1 (PyYAML's
        resolver) types it."""
        if "\t" in text:
            self.fail("a tab in a plain scalar", line)
        if _NULL.match(text):
            return None
        if _BOOL.match(text):
            return text.lower() in ("yes", "true", "on")
        if _FLOAT.match(text):
            return _to_float(text)
        if _INT.match(text):
            return _to_int(text)
        if text == "=":
            self.fail("the value key (=)", line)
        if _TIMESTAMP.match(text):
            self.fail("timestamps", line)
        return text

    def quoted(self, i: int, j: int, stay: bool = False):
        """The quoted scalar opening at (i, j): (value, position after its
        closing quote). Line breaks inside fold as YAML folds them. With
        `stay`, a scalar that does not close on its line returns at once
        with the position of its line's end."""
        q = self.lines[i][j]
        j += 1
        out: List[str] = []
        ws = ""
        while True:
            line = self.lines[i]
            if j >= len(line):
                if stay:
                    return None, (i + 1, 0)
                i, j, blanks = self._fold(i)
                ws = ""
                out.append("\n" * blanks if blanks else " ")
                continue
            c = line[j]
            if c in " \t":
                ws += c
                j += 1
                continue
            out.append(ws)
            ws = ""
            if q == "'":
                if c == "'":
                    if line[j + 1:j + 2] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return "".join(out), (i, j + 1)
                out.append(c)
                j += 1
                continue
            if c == '"':
                return "".join(out), (i, j + 1)
            if c != "\\":
                out.append(c)
                j += 1
                continue
            if j + 1 == len(line):          # an escaped line break
                if stay:
                    return None, (i + 1, 0)
                i, j, blanks = self._fold(i)
                out.append("\n" * blanks)
                continue
            e = line[j + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES:
                digits = line[j + 2:j + 2 + _HEX_ESCAPES[e]]
                if len(digits) != _HEX_ESCAPES[e] or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    self.fail(f"a bad \\{e} escape", i)
                out.append(chr(int(digits, 16)))
                j += 2 + len(digits)
            else:
                self.fail(f"an unknown escape \\{e}", i)

    def _fold(self, i: int) -> Tuple[int, int, int]:
        """Past a line break inside quotes: the next line with content, the
        column after its leading white space, and the blank lines between."""
        i += 1
        blanks = 0
        while i < len(self.lines) and not self.lines[i].strip(" \t"):
            blanks += 1
            i += 1
        if i == len(self.lines):
            self.fail("a quoted scalar that never closes", i - 1)
        line = self.lines[i]
        if _is_marker(line):
            self.fail("a document marker inside a quoted scalar", i)
        return i, len(line) - len(line.lstrip(" \t")), blanks

    # ------------------------------------------------------------ flow
    def _skip(self, i: int, j: int) -> Tuple[int, int]:
        """Past white space, line breaks and comments inside a flow
        collection."""
        while True:
            if i == len(self.lines):
                self.fail("a flow collection that never closes", i - 1)
            line = self.lines[i]
            if j >= len(line):
                i, j = i + 1, 0
                if i < len(self.lines) and _is_marker(self.lines[i]):
                    self.fail("a document marker inside a flow collection", i)
                continue
            c = line[j]
            if c == " ":
                j += 1
            elif c == "#":
                j = len(line)
            elif c == "\t":
                self.fail("a tab inside a flow collection", i)
            else:
                return i, j

    def flow(self, i: int, j: int):
        """The flow collection opening at (i, j): (value, position after
        its closing bracket)."""
        close = "]" if self.lines[i][j] == "[" else "}"
        out: Any = [] if close == "]" else {}
        i, j = self._skip(i, j + 1)
        while self.lines[i][j] != close:
            if close == "}":
                if self.lines[i][j] in "[{":
                    self.fail("a flow collection as a key", i)
                key, (i, j) = self.flow_node(i, j)
                i, j = self._skip(i, j)
                value = None
                if self.lines[i][j] == ":":
                    i, j = self._skip(i, j + 1)
                    if self.lines[i][j] not in ",}":
                        value, (i, j) = self.flow_node(i, j)
                        i, j = self._skip(i, j)
                out[key] = value
            else:
                item, (i, j) = self.flow_node(i, j)
                i, j = self._skip(i, j)
                if self.lines[i][j] == ":":
                    self.fail("a `key: value` pair inside a flow sequence", i)
                out.append(item)
            c = self.lines[i][j]
            if c == ",":
                i, j = self._skip(i, j + 1)
            elif c != close:
                self.fail(f"expected ',' or {close!r} in a flow collection, found {c!r}", i)
        return out, (i, j + 1)

    def flow_node(self, i: int, j: int):
        line = self.lines[i]
        c = line[j]
        if c in "[{":
            return self.flow(i, j)
        if c in "'\"":
            return self.quoted(i, j)
        if c in _NOT_PLAIN or c == "#":
            self.fail(_NOT_PLAIN.get(c, "a comment where a value belongs"), i)
        if c in ",]}" or (c in "-?:" and line[j + 1:j + 2] in _FLOW_END):
            self.fail(f"a flow entry that opens with {c!r}", i)
        parts: List[str] = []
        while True:
            k = j
            while k < len(line):
                c = line[k]
                if c in ",[]{}" or (c == ":" and line[k + 1:k + 2] in _FLOW_END):
                    break
                if c == "#" and line[k - 1] == " ":
                    break
                if c == "?":
                    self.fail("a '?' inside a plain scalar in a flow collection", i)
                k += 1
            parts.append(line[j:k].strip(" "))
            if line[k:].strip(" "):
                break
            # the scalar reaches the line's end: it goes on below unless a
            # flow indicator or a comment comes first (YAML folds the break)
            blanks, i2 = 0, i + 1
            while i2 < len(self.lines) and not self.lines[i2].strip(" "):
                blanks, i2 = blanks + 1, i2 + 1
            if i2 == len(self.lines):
                break
            nxt = self.lines[i2]
            j2 = len(nxt) - len(nxt.lstrip(" "))
            c = nxt[j2]
            if c in ",]}#" or (c == ":" and nxt[j2 + 1:j2 + 2] in _FLOW_END):
                break
            if _is_marker(nxt):
                self.fail("a document marker inside a flow collection", i2)
            parts.append("\n" * blanks if blanks else " ")
            i, j, line = i2, j2, nxt
        return self.plain("".join(parts), i), (i, k)


def safe_load(stream) -> Any:
    """The tree yaml.safe_load gives for `stream` (a str, or a file object
    read whole); ValueError outside the subset (see the module docstring)."""
    text = stream if isinstance(stream, str) else stream.read()
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    return _Reader(text).document()


# ------------------------------------------------------------------ writer
# a plain scalar the writer may leave unquoted: no indicator, quote,
# comment or flow character, no leading '-' and no edge spaces
_PLAIN_OUT = re.compile(r"^[A-Za-z0-9_/()+~$^][A-Za-z0-9_./()+=~$^ -]*$")


def _resolves_to_str(text: str) -> bool:
    return not (_BOOL.match(text) or _NULL.match(text) or _INT.match(text)
                or _FLOAT.match(text) or _TIMESTAMP.match(text))


def _quoted(text: str) -> str:
    """A double-quoted scalar: backslash, quote and every character YAML
    does not print or reads as a line break escaped."""
    out = []
    for c in text:
        o = ord(c)
        if c in '"\\':
            out.append("\\" + c)
        elif c in "\n\t\r":
            out.append({"\n": "\\n", "\t": "\\t", "\r": "\\r"}[c])
        elif o < 0x20 or o == 0x7f or 0x80 <= o < 0xa0 or o in (0x2028, 0x2029, 0xfeff) \
                or 0xd800 <= o < 0xe000:
            out.append(f"\\x{o:02x}" if o < 0x100 else f"\\u{o:04x}")
        else:
            out.append(c)
    return '"' + "".join(out) + '"'


def _scalar_out(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        # YAML 1.1 reads a float only with a '.' (PyYAML writes 1.0e-05 too)
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(value, str):
        plain = (value and value == value.strip() and _PLAIN_OUT.match(value)
                 and "  " not in value and _resolves_to_str(value))
        return value if plain else _quoted(value)
    if isinstance(value, dict) and not value:
        return "{}"
    if isinstance(value, list) and not value:
        return "[]"
    raise TypeError(f"safe_dump cannot write a {type(value).__name__}")


def _block(value: Any, indent: int) -> List[str]:
    """The lines of a non-empty mapping or sequence at column `indent`;
    a sequence under a key sits at the key's column, as PyYAML writes it."""
    pad = " " * indent
    lines: List[str] = []
    if isinstance(value, dict):
        for key, val in value.items():
            head = f"{pad}{_scalar_out(key)}:"
            if isinstance(val, dict) and val:
                lines += [head, *_block(val, indent + 2)]
            elif isinstance(val, list) and val:
                lines += [head, *_block(val, indent)]
            else:
                lines.append(f"{head} {_scalar_out(val)}")
        return lines
    for item in value:
        if isinstance(item, (dict, list)) and item:
            sub = _block(item, indent + 2)
            lines += [f"{pad}- {sub[0][indent + 2:]}", *sub[1:]]
        else:
            lines.append(f"{pad}- {_scalar_out(item)}")
    return lines


def safe_dump(data: Any) -> str:
    """YAML text that yaml.safe_load and safe_load read back as `data`:
    dicts (keys in their order) and lists in block style, scalars plain
    where that reads back the same, else double-quoted. Takes what
    safe_load returns: dict, list, str, int, float, bool, None."""
    if isinstance(data, (dict, list)) and data:
        return "\n".join(_block(data, 0)) + "\n"
    return _scalar_out(data) + "\n"
