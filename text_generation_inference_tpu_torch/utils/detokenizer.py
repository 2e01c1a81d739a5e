"""Incremental detokenization with streaming == non-streaming parity.

The reference implements five decoder-family-specific incremental decoders in
Rust (reference: router/src/decoder.rs:12-158: ByteLevel, Metaspace/WordPiece
first-diff, BPE last-diff, CTC dedup, plus a Llama "Sequence" workaround) to
turn per-step token ids into exact text deltas. This implementation gets the
same guarantees with a single algorithm: a sliding window of recent ids is
re-decoded each step and the previously-emitted prefix is subtracted, so any
tokenizer's context-dependent continuation rules are applied by the tokenizer
itself. Incomplete UTF-8 output (the replacement character at the window
end) is deferred until complete, mirroring decoder.rs:469-495.

Invariant (tested): the concatenation of emitted deltas equals the one-shot
`decode()` of the full id sequence — the reference's "parity of streaming and
non-streaming output" README guarantee.
"""

from __future__ import annotations

from typing import Optional

REPLACEMENT_CHAR = "�"


class IncrementalDecoder:
    def __init__(self, tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip_special = skip_special_tokens
        self.ids: list[int] = []
        self._prefix_offset = 0   # window start (id index)
        self._read_offset = 0     # ids already represented in emitted text

    def _decode(self, ids: list[int]) -> str:
        if not ids:
            return ""
        return self._tok.decode(ids, skip_special_tokens=self._skip_special)

    def push(self, token_id: int) -> str:
        """Add one generated id; return the newly-complete text (maybe '')."""
        self.ids.append(token_id)
        prefix_text = self._decode(self.ids[self._prefix_offset:self._read_offset])
        new_text = self._decode(self.ids[self._prefix_offset:])
        if len(new_text) > len(prefix_text) and not new_text.endswith(REPLACEMENT_CHAR):
            delta = new_text[len(prefix_text):]
            self._prefix_offset = self._read_offset
            self._read_offset = len(self.ids)
            return delta
        # tokens that complete no new text yet (e.g. partial UTF-8) are held
        return ""

    def flush(self) -> str:
        """Emit whatever is still buffered (call at end of generation)."""
        prefix_text = self._decode(self.ids[self._prefix_offset:self._read_offset])
        new_text = self._decode(self.ids[self._prefix_offset:])
        delta = new_text[len(prefix_text):] if len(new_text) > len(prefix_text) else ""
        self._read_offset = len(self.ids)
        self._prefix_offset = max(self._read_offset - 8, 0)
        return delta


class CTCIncrementalDecoder(IncrementalDecoder):
    """CTC-family incremental decoder (speech models, e.g. wav2vec2).

    The sliding-window subtraction algorithm is WRONG for CTC: the
    tokenizer's CTC decode collapses consecutive duplicate ids, and that
    dedup state crosses window boundaries (ids [A | A] split across windows
    would emit A's text twice). The reference handles CTC with a dedicated
    dedup decoder (reference: router/src/decoder.rs:339-372,
    IncrementalDeDupDecoder): a token equal to the immediately-preceding
    token emits nothing; otherwise the single token is decoded on its own
    and appended (blank/pad removal and word-delimiter mapping happen
    inside the tokenizer's CTC decoder).
    """

    def __init__(self, tokenizer, skip_special_tokens: bool = True):
        super().__init__(tokenizer, skip_special_tokens)
        self._last_id: Optional[int] = None

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        if token_id == self._last_id:
            return ""
        self._last_id = token_id
        return self._decode([token_id])

    def flush(self) -> str:
        return ""


def make_incremental_decoder(tokenizer, skip_special_tokens: bool = True):
    """Pick the incremental decoder for a tokenizer: the CTC dedup decoder
    when the tokenizer.json declares a CTC decoder (reference:
    router/src/decoder.rs:117-158 routes on the decoder kind), else the
    family-agnostic sliding-window decoder."""
    if getattr(tokenizer, "decoder_type", None) == "CTC":
        return CTCIncrementalDecoder(tokenizer, skip_special_tokens)
    return IncrementalDecoder(tokenizer, skip_special_tokens)


class StopStateBase:
    """Shared output-assembly over an accumulated UTF-8 BYTE buffer.

    All offsets (match ends, hold-back lengths) are byte offsets of the
    UTF-8 stream — matching the reference, which evaluates stop sequences
    on byte subslices to avoid UTF-8 boundary problems (reference:
    router/src/batcher.rs:792-807) and holds back `hold_back_bytes` from
    streaming (decoder.rs:162-526). Subclasses implement the matcher
    (`feed`/`held_back_len`); this base renders final/visible text.
    """

    stop_sequences: list[str]
    include: bool

    def __init__(self, stop_sequences: list[str], include_stop_sequence: bool):
        self.stop_sequences = stop_sequences
        self.include = include_stop_sequence
        self._buf = bytearray()
        self._matched: Optional[tuple[str, int]] = None

    @property
    def text(self) -> str:
        return bytes(self._buf).decode("utf-8", errors="replace")

    def feed(self, delta: str) -> Optional[tuple[str, int]]:
        raise NotImplementedError

    def held_back_len(self) -> int:
        """Trailing BYTES withheld from streaming because they could still
        become part of a stop sequence."""
        raise NotImplementedError

    def final_text(self, matched: Optional[tuple[str, int]] = None) -> str:
        """Full output text, trimmed per the include_stop_sequence setting.
        `matched` is (sequence, byte_end_of_match)."""
        m = matched if matched is not None else self._matched
        if m is None:
            end = len(self._buf)
        else:
            seq, match_end = m
            end = match_end if self.include else match_end - len(seq.encode())
        return bytes(self._buf[:end]).decode("utf-8", errors="replace")

    def visible_text(self, matched, final: bool) -> str:
        """Prefix of the output safe to stream: everything on final;
        while streaming, the text minus (a) the stop-sequence byte
        hold-back and (b) the last grapheme cluster, which a later token
        could still extend (reference: decoder.rs:487-493)."""
        if final:
            return self.final_text(matched)
        end = len(self._buf) - self.held_back_len()
        # a byte cut can land mid-codepoint; drop the partial tail
        text = bytes(self._buf[:end]).decode("utf-8", errors="ignore")
        from . import graphemes

        return text[: graphemes.safe_emit_len(text)]


class StopSequenceState(StopStateBase):
    """Pure-Python byte-exact matcher (fallback when libtokenproc.so is not
    built); same semantics as utils/native_tokenproc.NativeStopState."""

    def __init__(self, stop_sequences: list[str], include_stop_sequence: bool):
        super().__init__(stop_sequences, include_stop_sequence)
        self._seqs = [s.encode() for s in stop_sequences]
        self._max_len = max((len(b) for b in self._seqs), default=0)

    def feed(self, delta: str) -> Optional[tuple[str, int]]:
        """Append delta; if a stop sequence completed inside the new bytes,
        return (sequence, byte_end_index_in_full_stream). Scans only the
        window that could contain a newly-completed match."""
        if self._matched is not None:
            return self._matched
        if not self._seqs:
            self._buf.extend(delta.encode())
            return None
        start_scan = max(len(self._buf) - self._max_len + 1, 0)
        self._buf.extend(delta.encode())
        window = bytes(self._buf[start_scan:])
        best: Optional[tuple[str, int]] = None
        for seq, b in zip(self.stop_sequences, self._seqs):
            idx = window.find(b)
            if idx != -1:
                end = start_scan + idx + len(b)
                if best is None or end < best[1]:
                    best = (seq, end)
        self._matched = best
        return best

    def held_back_len(self) -> int:
        if not self._seqs:
            return 0
        held = 0
        for b in self._seqs:
            for k in range(min(len(b) - 1, len(self._buf)), 0, -1):
                if self._buf.endswith(b[:k]):
                    held = max(held, k)
                    break
        return held
