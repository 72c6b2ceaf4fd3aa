"""Guided JSON decoding: a byte-level automaton compiled to dense
tables, enforced inside the sampling step on the device.

OpenAI ``response_format: {"type": "json_object"}``. The automaton is a
depth-bounded JSON DFA over bytes: states are (mode, container stack,
pending literal) triples discovered by BFS from the start state, and
compiled to two tables:

  transition [n_states, width] int32  next state (-1 = disallowed)
  mask       [n_states, width] bool   token admissible from the state

The runner uploads them to the device once (``ModelRunner
.set_guided_tables``). Each sampling step gathers ``mask[state]`` to
mask the disallowed logits, last in the option chain
(``ops/sampling.apply_guided_mask``); a decode burst carries the
per-row state and advances it on the device
(``ops/sampling.guided_advance``). The host mirrors every appended
token through ``advance`` (the scheduler's hook), so each dispatch
starts from the current state.

Scope: tokenizers whose ids 0-255 are the UTF-8 bytes (the byte and
bench tokenizers of engine/tokenizer.py); every other id is
inadmissible except EOS, which is admissible in the DONE state only.
This is the port's own copy of the JAX package's automaton: the same
states in the same order, so the same tables.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

WS = tuple(b" \t\n\r")
DIGITS = tuple(b"0123456789")
HEX = tuple(b"0123456789abcdefABCDEF")
# String-body bytes: anything printable-ish except '"' and '\\';
# control bytes (< 0x20) are invalid inside JSON strings. Non-ASCII
# UTF-8 continuation/lead bytes are allowed (the automaton does not
# validate UTF-8 sequences — the decoded text may contain replacement
# characters with random weights, but the JSON STRUCTURE is valid).
STR_BYTES = tuple(b for b in range(0x20, 256) if b not in (0x22, 0x5C))

# Modes (stack-independent part of a state).
(START, EXP_KEY_OR_CLOSE, EXP_KEY, KEY_STR, KEY_ESC, KEY_U1, KEY_U2,
 KEY_U3, KEY_U4, EXP_COLON, EXP_VALUE, EXP_VAL_OR_CLOSE, VAL_STR,
 VAL_ESC, VAL_U1, VAL_U2, VAL_U3, VAL_U4, AFTER_VALUE, NUM_MINUS,
 NUM_ZERO, NUM_INT, NUM_DOT, NUM_FRAC, NUM_E, NUM_EXP_SIGNED,
 NUM_EXP, LIT, DONE) = range(29)

_LITERALS = (b"true", b"false", b"null")


class JsonByteFsm:
    """Depth-bounded JSON automaton over bytes, with dense tables.

    A state is (mode, stack, lit_rest): ``stack`` is a tuple of
    b'{'/b'[' container markers (len <= max_depth), ``lit_rest`` the
    remaining bytes of an in-flight true/false/null literal. States
    are interned ints in discovery order; state 0 is START.
    """

    # Table width: bytes 0-255 + bos/eos specials. Every id >= 258 is
    # inadmissible by construction (byte-range tokenizer contract), so
    # the dense tables stop there — [n_states, vocab] at a 32k bench
    # vocab would cost ~300 MB for columns that are uniformly -1; the
    # runner pads the gathered mask rows back to vocab width.
    TABLE_WIDTH = 258

    def __init__(self, vocab_size: int, eos_token_id: int,
                 max_depth: int = 6):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id
        self.max_depth = max_depth
        assert eos_token_id is None or eos_token_id < self.TABLE_WIDTH
        width = min(vocab_size, self.TABLE_WIDTH)
        self._ids: Dict[tuple, int] = {}
        self._work: list = []
        start = self._intern((START, (), b""))
        assert start == 0
        trans_rows = []
        while self._work:
            key = self._work.pop(0)
            trans_rows.append(self._row(key))
        n = len(self._ids)
        self.transition = np.full((n, width), -1, np.int32)
        for i, row in enumerate(trans_rows):
            for tok, nxt in row.items():
                self.transition[i, tok] = nxt
        self.mask = self.transition >= 0

    # -- state construction --------------------------------------------------

    def _intern(self, key: tuple) -> int:
        if key not in self._ids:
            self._ids[key] = len(self._ids)
            self._work.append(key)
        return self._ids[key]

    def _row(self, key: tuple) -> Dict[int, int]:
        """byte/token -> next state id for one state."""
        mode, stack, lit = key
        out: Dict[int, int] = {}

        def to(b: int, mode2, stack2=None, lit2=b""):
            out[b] = self._intern(
                (mode2, stack if stack2 is None else stack2, lit2))

        def ws_self():
            for b in WS:
                to(b, mode, lit2=lit)

        def close_container(b_close: int):
            """'}' or ']' closing the innermost container."""
            want = 0x7D if stack[-1] == 0x7B else 0x5D
            if b_close != want:
                return
            popped = stack[:-1]
            if not popped:
                to(b_close, DONE, popped)
            else:
                to(b_close, AFTER_VALUE, popped)

        def open_value(b: int):
            """Transitions a value-start byte out of EXP_VALUE."""
            if b == 0x22:
                to(b, VAL_STR)
            elif b == 0x2D:
                to(b, NUM_MINUS)
            elif b == 0x30:
                to(b, NUM_ZERO)
            elif b in DIGITS:
                to(b, NUM_INT)
            elif b in (0x74, 0x66, 0x6E):  # t / f / n
                word = {0x74: b"true", 0x66: b"false",
                        0x6E: b"null"}[b]
                to(b, LIT, lit2=word[1:])
            elif b == 0x7B and len(stack) < self.max_depth:
                to(b, EXP_KEY_OR_CLOSE, stack + (0x7B,))
            elif b == 0x5B and len(stack) < self.max_depth:
                to(b, EXP_VAL_OR_CLOSE, stack + (0x5B,))

        def value_done():
            """State reached after a complete value: depends on the
            innermost container (objects expect , or }, arrays , or
            ])."""
            return (DONE, ()) if not stack else (AFTER_VALUE, stack)

        def number_delims():
            """A number is 'done' at any delimiter its context
            allows: whitespace/comma/close route as AFTER_VALUE."""
            m2, st2 = value_done()
            if m2 == DONE:
                for b in WS:
                    to(b, DONE, ())
                return
            for b in WS:
                to(b, AFTER_VALUE)
            for b, row_mode in self._after_value_bytes(stack):
                out[b] = row_mode

        if mode == START:
            ws_self()
            to(0x7B, EXP_KEY_OR_CLOSE, (0x7B,))
        elif mode == EXP_KEY_OR_CLOSE:
            ws_self()
            to(0x22, KEY_STR)
            close_container(0x7D)
        elif mode == EXP_KEY:
            ws_self()
            to(0x22, KEY_STR)
        elif mode in (KEY_STR, VAL_STR):
            esc = KEY_ESC if mode == KEY_STR else VAL_ESC
            for b in STR_BYTES:
                to(b, mode, lit2=lit)
            to(0x5C, esc)
            if mode == KEY_STR:
                to(0x22, EXP_COLON)
            else:
                m2, st2 = value_done()
                to(0x22, m2, st2)
        elif mode in (KEY_ESC, VAL_ESC):
            back = KEY_STR if mode == KEY_ESC else VAL_STR
            u1 = KEY_U1 if mode == KEY_ESC else VAL_U1
            for b in b'"\\/bfnrt':
                to(b, back)
            to(0x75, u1)  # \uXXXX
        elif mode in (KEY_U1, KEY_U2, KEY_U3, VAL_U1, VAL_U2, VAL_U3):
            for b in HEX:
                to(b, mode + 1)
        elif mode in (KEY_U4, VAL_U4):
            back = KEY_STR if mode == KEY_U4 else VAL_STR
            for b in HEX:
                to(b, back)
        elif mode == EXP_COLON:
            ws_self()
            to(0x3A, EXP_VALUE)
        elif mode == EXP_VALUE:
            ws_self()
            for b in (0x22, 0x2D, 0x7B, 0x5B) + DIGITS + (
                    0x74, 0x66, 0x6E):
                open_value(b)
        elif mode == EXP_VAL_OR_CLOSE:
            ws_self()
            for b in (0x22, 0x2D, 0x7B, 0x5B) + DIGITS + (
                    0x74, 0x66, 0x6E):
                open_value(b)
            close_container(0x5D)
        elif mode == AFTER_VALUE:
            ws_self()
            for b, nxt in self._after_value_bytes(stack):
                out[b] = nxt
        elif mode == NUM_MINUS:
            to(0x30, NUM_ZERO)
            for b in DIGITS[1:]:
                to(b, NUM_INT)
        elif mode in (NUM_ZERO, NUM_INT, NUM_FRAC, NUM_EXP):
            if mode == NUM_INT:
                for b in DIGITS:
                    to(b, NUM_INT)
            if mode == NUM_FRAC:
                for b in DIGITS:
                    to(b, NUM_FRAC)
            if mode == NUM_EXP:
                for b in DIGITS:
                    to(b, NUM_EXP)
            if mode in (NUM_ZERO, NUM_INT):
                to(0x2E, NUM_DOT)
            if mode != NUM_EXP:
                to(0x65, NUM_E)
                to(0x45, NUM_E)
            number_delims()
        elif mode == NUM_DOT:
            for b in DIGITS:
                to(b, NUM_FRAC)
        elif mode == NUM_E:
            to(0x2B, NUM_EXP_SIGNED)
            to(0x2D, NUM_EXP_SIGNED)
            for b in DIGITS:
                to(b, NUM_EXP)
        elif mode == NUM_EXP_SIGNED:
            for b in DIGITS:
                to(b, NUM_EXP)
        elif mode == LIT:
            nxt_b = lit[0]
            rest = lit[1:]
            if rest:
                to(nxt_b, LIT, lit2=rest)
            else:
                m2, st2 = value_done()
                to(nxt_b, m2, st2)
        elif mode == DONE:
            ws_self()
            if self.eos_token_id is not None:
                out[self.eos_token_id] = self._intern((DONE, (), b""))
        return out

    def _after_value_bytes(self, stack) -> list:
        """(byte, next_state_id) continuations after a complete value
        inside ``stack``'s innermost container."""
        res = []
        if not stack:
            return res
        if stack[-1] == 0x7B:
            res.append((0x2C, self._intern((EXP_KEY, stack, b""))))
            popped = stack[:-1]
            res.append((0x7D, self._intern(
                (DONE, (), b"") if not popped
                else (AFTER_VALUE, popped, b""))))
        else:
            res.append((0x2C, self._intern((EXP_VALUE, stack, b""))))
            popped = stack[:-1]
            res.append((0x5D, self._intern(
                (DONE, (), b"") if not popped
                else (AFTER_VALUE, popped, b""))))
        return res

    # -- host-side mirror ----------------------------------------------------

    def advance(self, state: int, token: int) -> int:
        """Host-side transition (same table the device gathers);
        ids beyond the table width are inadmissible."""
        if token >= self.transition.shape[1]:
            return -1
        return int(self.transition[state, token])


def build_json_fsm(tokenizer, max_depth: int = 6) -> JsonByteFsm:
    """Build the automaton for a byte-range tokenizer.

    Requires ids 0-255 to BE the UTF-8 bytes (ByteTokenizer /
    BenchTokenizer contract); every other id is inadmissible except
    EOS (DONE state only)."""
    return JsonByteFsm(tokenizer.vocab_size, tokenizer.eos_token_id,
                       max_depth=max_depth)
