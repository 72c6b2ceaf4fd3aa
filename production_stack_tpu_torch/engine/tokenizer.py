"""Tokenizers for the port's random-weights models.

The dependency-free byte tokenizer and its full-vocab decode variant
(the one ``--model bench-1b`` serves with), plus the role-tagged chat
rendering the server uses for ``/v1/chat/completions``. Checkpoint
tokenizers arrive with checkpoint loading, which this port does not
have yet.
"""

from __future__ import annotations

from typing import List, Optional


class BaseTokenizer:
    eos_token_id: int

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, token_ids: List[int]) -> str:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError


class ByteTokenizer(BaseTokenizer):
    """UTF-8 bytes + <bos>=256, <eos>=257. Vocab 512 (room for specials)."""

    BOS = 256
    EOS = 257

    def __init__(self):
        self.eos_token_id = self.EOS

    def encode(self, text: str) -> List[int]:
        return [self.BOS] + list(text.encode("utf-8"))

    def decode(self, token_ids: List[int]) -> str:
        data = bytes(t for t in token_ids if 0 <= t < 256)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 512


class BenchTokenizer(ByteTokenizer):
    """ByteTokenizer whose decode covers a full random-weights vocab.

    A random-weights server pairs a real model vocab (e.g. 32,128)
    with the byte tokenizer, whose decode range is 0-255: greedy tokens
    under random weights are almost surely >= 256 and would decode to
    nothing. Here every id >= 258 decodes to one printable ASCII char,
    so each generated token yields exactly one non-empty delta, while
    encode stays byte-level (realistic prompt token counts).
    """

    def __init__(self, vocab_size: int = 32128):
        super().__init__()
        self._vocab_size = vocab_size

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def decode(self, token_ids: List[int]) -> str:
        out: List[str] = []
        run: List[int] = []  # contiguous byte-range ids
        for t in token_ids:
            if 0 <= t < 256:
                run.append(t)
                continue
            if run:
                out.append(bytes(run).decode("utf-8", errors="replace"))
                run = []
            if t >= 258:  # 256/257 are bos/eos (specials: skipped)
                out.append(chr(33 + (t - 258) % 94))
        if run:
            out.append(bytes(run).decode("utf-8", errors="replace"))
        return "".join(out)


def get_tokenizer(spec: Optional[str]) -> BaseTokenizer:
    """spec: None/'byte' -> ByteTokenizer; 'bench' -> BenchTokenizer."""
    if spec in (None, "byte"):
        return ByteTokenizer()
    if spec == "bench":
        return BenchTokenizer()
    raise ValueError(f"unknown tokenizer {spec!r} (byte | bench)")


def render_chat_prompt(tokenizer: BaseTokenizer, messages) -> List[int]:
    """Messages -> prompt token ids with a simple role-tagged
    rendering (the byte tokenizers carry no chat template)."""
    text = "".join(
        f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}\n"
        for m in messages
    ) + "<|assistant|>\n"
    return tokenizer.encode(text)
