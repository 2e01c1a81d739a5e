"""Grapheme-cluster boundary detection for streaming emission.

The reference never streams a partial grapheme cluster: emitted text is cut
at the last cluster boundary so a later token can still attach combining
marks / ZWJ continuations to the held-back tail (reference:
router/src/decoder.rs:487-493, via the unicode-segmentation crate).

This is a dependency-free UAX #29 subset built on `unicodedata`, covering
the rules that matter for LLM output streams: combining marks (GB9/9a),
ZWJ emoji sequences (GB11, approximated as "anything joins after ZWJ"),
variation selectors and skin-tone modifiers, regional-indicator pairs
(GB12/13), Hangul jamo composition (GB6-8), and CRLF (GB3). The
approximations only ever *over*-join (holding text back slightly longer),
never split a real cluster — held text is flushed at end of generation, so
over-joining delays streaming by at most one cluster and cannot corrupt
output.
"""

from __future__ import annotations

import unicodedata

ZWJ = "\u200d"


def _is_extend(ch: str) -> bool:
    if ch == ZWJ:
        return True
    if "\ufe00" <= ch <= "\ufe0f":            # variation selectors
        return True
    if "\U0001f3fb" <= ch <= "\U0001f3ff":    # emoji skin-tone modifiers
        return True
    return unicodedata.category(ch) in ("Mn", "Me", "Mc")


def _is_regional_indicator(ch: str) -> bool:
    return "\U0001f1e6" <= ch <= "\U0001f1ff"


def _hangul_type(ch: str) -> str | None:
    cp = ord(ch)
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return None


def _is_boundary(prev: str, ch: str, ri_run: int) -> bool:
    """Is there a cluster boundary between prev and ch? `ri_run` = length of
    the regional-indicator run ending at prev."""
    if prev == "\r" and ch == "\n":                      # GB3
        return False
    # GB4/5: break around controls (other than ZWJ, handled as Extend)
    if prev in "\r\n" or ch in "\r\n":
        return True
    pcat = unicodedata.category(prev)
    ccat = unicodedata.category(ch)
    if pcat in ("Cc", "Cf") and prev != ZWJ:
        return True
    if ccat in ("Cc", "Cf") and not _is_extend(ch):
        return True
    hp, hc = _hangul_type(prev), _hangul_type(ch)        # GB6-8
    if hp == "L" and hc in ("L", "V", "LV", "LVT"):
        return False
    if hp in ("LV", "V") and hc in ("V", "T"):
        return False
    if hp in ("LVT", "T") and hc == "T":
        return False
    if _is_extend(ch):                                   # GB9/9a
        return False
    if prev == ZWJ:                                      # GB11 (approx)
        return False
    if _is_regional_indicator(prev) and _is_regional_indicator(ch):
        return ri_run % 2 == 0                           # GB12/13: pairs
    return True


def last_cluster_start(text: str) -> int:
    """Index (in code points) where the final grapheme cluster begins;
    0 for empty or single-cluster text."""
    start = 0
    ri_run = 0
    for i in range(1, len(text)):
        prev, ch = text[i - 1], text[i]
        if _is_regional_indicator(prev):
            ri_run += 1
        else:
            ri_run = 0
        if _is_boundary(prev, ch, ri_run):
            start = i
    return start


def safe_emit_len(text: str) -> int:
    """Length of the prefix safe to stream now: everything before the final
    cluster (which may still grow). Matches the reference's behavior of
    holding back through the last grapheme boundary (decoder.rs:487-493)."""
    return last_cluster_start(text)
