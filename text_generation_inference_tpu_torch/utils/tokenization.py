"""Tokenizer wrapper + async tokenization pool.

The reference router loads the HF fast tokenizer directly and disables its
truncation/padding (reference: router/src/main.rs:105), running blocking
tokenization on a dedicated thread pool (reference: router/src/tokenizer.rs).
Same here, on `concurrent.futures`.
"""

from __future__ import annotations

import asyncio
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from tokenizers import Tokenizer


class ServingTokenizer:
    """Uniform facade over a `tokenizers.Tokenizer` (tokenizer.json)."""

    def __init__(self, tok: Tokenizer, eos_token_id: Optional[int],
                 special_ids: Optional[set[int]] = None,
                 decoder_type: Optional[str] = None):
        self._tok = tok
        tok.no_truncation()
        tok.no_padding()
        self.eos_token_id = eos_token_id
        self._special_ids = special_ids or set()
        # decoder family from tokenizer.json (e.g. "ByteLevel", "CTC") —
        # the detokenizer routes CTC to a dedup decoder (reference:
        # router/src/decoder.rs:117-158 matches on the decoder kind)
        self.decoder_type = decoder_type

    @classmethod
    def load(cls, model_dir: str) -> "ServingTokenizer":
        from tokenizers import Tokenizer

        d = Path(model_dir)
        tok = Tokenizer.from_file(str(d / "tokenizer.json"))
        decoder_type = None
        try:
            dec = json.loads((d / "tokenizer.json").read_text()).get("decoder")
            if isinstance(dec, dict):
                decoder_type = dec.get("type")
        except Exception:
            pass
        eos_id = None
        cfg_path = d / "config.json"
        if cfg_path.exists():
            eos = json.loads(cfg_path.read_text()).get("eos_token_id")
            if isinstance(eos, list):
                eos = eos[0] if eos else None
            eos_id = eos
        if eos_id is None:
            tok_cfg = d / "tokenizer_config.json"
            if tok_cfg.exists():
                eos_tok = json.loads(tok_cfg.read_text()).get("eos_token")
                if isinstance(eos_tok, dict):
                    eos_tok = eos_tok.get("content")
                if eos_tok is not None:
                    eos_id = tok.token_to_id(eos_tok)
        special = set()
        st_path = d / "special_tokens_map.json"
        if st_path.exists():
            for v in json.loads(st_path.read_text()).values():
                toks = v if isinstance(v, list) else [v]
                for t in toks:
                    content = t.get("content") if isinstance(t, dict) else t
                    tid = tok.token_to_id(content) if content else None
                    if tid is not None:
                        special.add(tid)
        return cls(tok, eos_id, special, decoder_type=decoder_type)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def encode_full(self, text: str):
        """Returns the full Encoding (ids, tokens, offsets) for the Tokenize API."""
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: list[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def id_to_token(self, token_id: int) -> str:
        t = self._tok.id_to_token(token_id)
        return t if t is not None else ""

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


class AsyncTokenizer:
    """Tokenization on a dedicated thread pool with an async interface."""

    def __init__(self, tokenizer: ServingTokenizer, num_threads: int = 4):
        self.tokenizer = tokenizer
        self._pool = ThreadPoolExecutor(
            max_workers=num_threads, thread_name_prefix="tokenizer")

    async def encode(self, text: str) -> list[int]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, self.tokenizer.encode, text)

    async def encode_full(self, text: str):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, self.tokenizer.encode_full, text)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
