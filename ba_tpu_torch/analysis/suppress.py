"""Inline suppression comments and annotations
(``ba_tpu/analysis/suppress.py``): ``# ba-lint: disable=BAxxx``.

Both forms are parsed from real comment tokens (``tokenize``, not a
regex over raw lines), so a docstring that documents the syntax, like
this one, never registers as a live directive:

- line-scoped, appended to the flagged line::

      ev.synchronize()  # ba-lint: disable=BA101 (the depth-delayed retire)

  Several codes are comma-separated (``disable=BA101,BA202``); ``all``
  silences every rule on the line.
- file-scoped, a comment on its own line anywhere in the file::

      # ba-lint: disable-file=BA401

Suppressed findings still count in the JSON summary (``suppressed``) so
a tree that gathers waivers shows it, but they never fail the run.

Declarative annotations ride the same channel:

- ``# ba-lint: thread-entry``, on a ``def`` line: the concurrency rules
  treat the function as a thread entry point although no
  ``threading.Thread(target=...)`` / ``Timer`` call in the analyzed set
  names it (dispatch through a registry or a callback table);
- ``# ba-lint: lockfree``, on its own line: the module is under BA502's
  lock-free read discipline.
"""

from __future__ import annotations

import io
import re
import tokenize

_LINE_RE = re.compile(r"#\s*ba-lint:\s*disable=([A-Za-z0-9,\s]+)")
_FILE_RE = re.compile(r"#\s*ba-lint:\s*disable-file=([A-Za-z0-9,\s]+)")
# Declarative annotations: `thread-entry` is line-scoped (on the def
# line); `lockfree` is file-scoped (own-line only, like disable-file).
_ANNO_RE = re.compile(r"#\s*ba-lint:\s*(thread-entry|lockfree)\b")


def _codes(group: str) -> set[str]:
    return {c.strip().upper() for c in group.split(",") if c.strip()}


class SuppressionIndex:
    """Per-file map of suppressed codes by line, plus file-wide codes."""

    def __init__(self, source: str):
        self.by_line: dict[int, set[str]] = {}
        self.file_wide: set[str] = set()
        # Annotations: line -> tokens (thread-entry), plus file-wide
        # declarations (lockfree).
        self.annotations: dict[int, set[str]] = {}
        self.file_annotations: set[str] = set()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            comments = [
                (tok.start, tok.string, tok.line)
                for tok in tokens
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # Unparseable files surface as BA900 findings; suppression
            # directives in them are moot.
            return
        for (lineno, col), text, line in comments:
            m = _FILE_RE.search(text)
            if m:
                # Own-line comments only: a TRAILING disable-file would
                # silently waive a whole file where the author plainly
                # meant one line — ignore it rather than over-apply it.
                if line[:col].strip() == "":
                    self.file_wide |= _codes(m.group(1))
                continue
            m = _LINE_RE.search(text)
            if m:
                self.by_line[lineno] = _codes(m.group(1))
                continue
            m = _ANNO_RE.search(text)
            if m:
                token = m.group(1)
                if token == "lockfree":
                    # Own-line only, mirroring disable-file: a TRAILING
                    # lockfree would put a whole module under the BA502
                    # discipline where the author plainly meant to
                    # annotate one line.
                    if line[:col].strip() == "":
                        self.file_annotations.add(token)
                else:
                    self.annotations.setdefault(lineno, set()).add(token)

    def is_suppressed(self, code: str, line: int) -> bool:
        for active in (self.file_wide, self.by_line.get(line, ())):
            if code in active or "ALL" in active:
                return True
        return False
