"""Tokenizer abstraction, the JAX package's ``engine/tokenizer.py`` in
the port.

HF tokenizers load from a local path (a checkpoint directory's own, or
``--tokenizer PATH``); ``HFTokenizer`` imports ``transformers`` when it
is built, so a host without that package fails there, at start-up. The
dependency-free byte tokenizer and its full-vocab decode variant (the
one the random-weights presets serve with) need nothing.
``render_chat_prompt`` renders ``/v1/chat/completions`` messages: an
operator's ``--chat-template`` first, then the model's own template,
then a role-tagged rendering.
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


class HFTokenizer(BaseTokenizer):
    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path)
        self.eos_token_id = self._tok.eos_token_id

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def encode_rendered(self, text: str) -> List[int]:
        """Encode text a chat template already rendered: no extra
        special tokens (the template embeds BOS etc. itself)."""
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, token_ids: List[int]) -> str:
        return self._tok.decode(token_ids, skip_special_tokens=True)

    def apply_chat_template(self, messages) -> Optional[List[int]]:
        try:
            return self._tok.apply_chat_template(
                messages, add_generation_prompt=True)
        except Exception:
            return None

    @property
    def vocab_size(self) -> int:
        return len(self._tok)


def get_tokenizer(spec: Optional[str]) -> BaseTokenizer:
    """spec: None/'byte' -> ByteTokenizer; 'bench' -> BenchTokenizer
    (full-vocab decode for random-weights servers, at its default
    vocab); otherwise a local HF path."""
    if spec in (None, "byte"):
        return ByteTokenizer()
    if spec == "bench":
        return BenchTokenizer()
    return HFTokenizer(spec)


def render_chat_prompt(tokenizer: BaseTokenizer, messages,
                       chat_template: Optional[str] = None) -> List[int]:
    """Messages -> prompt token ids.

    Priority: an explicit ``chat_template`` (Jinja source, the
    ``--chat-template`` override) > the model's own template > a simple
    role-tagged rendering. A template that fails to render falls back,
    with a warning (the server renders it once at start-up, so a broken
    one never gets this far)."""
    if chat_template:
        try:
            import jinja2
            text = jinja2.Template(chat_template).render(
                messages=messages, add_generation_prompt=True)
            # The template renders its own special tokens; encoding
            # must not prepend a second BOS.
            if isinstance(tokenizer, HFTokenizer):
                return tokenizer.encode_rendered(text)
            return tokenizer.encode(text)
        except Exception as e:
            from production_stack_tpu_torch.utils.log import init_logger
            init_logger(__name__).warning(
                "--chat-template failed to render (%r); falling back "
                "to the model's own template", e)
    if isinstance(tokenizer, HFTokenizer):
        ids = tokenizer.apply_chat_template(messages)
        if ids is not None:
            return ids
    text = "".join(
        f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}\n"
        for m in messages
    ) + "<|assistant|>\n"
    return tokenizer.encode(text)
