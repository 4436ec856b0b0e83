"""Constrained decoding: OpenAI ``response_format: {"type": "json_object"}``
(``dynamo_tpu/constrained.py``, copied whole: numpy only, masks bitwise the
JAX build's).

Guarantees every generated token keeps the output a valid JSON *prefix*,
and (unlike OpenAI's "may truncate at max_tokens" caveat) force-closes
open structures when the remaining token budget runs low, so finished
responses parse.

Design, sized for a 128k vocabulary:

- **Char-level JSON pushdown machine** (:class:`MachineState`,
  :func:`advance`): mode + container stack; accepts exactly the prefixes of
  JSON values (strings with escapes, numbers, literals, arrays, objects).
- **Token masks cached by machine summary** (:class:`TokenMaskCache`):
  the set of allowed next TOKENS depends only on a bounded summary of the
  machine (mode, pending literal, top few stack symbols) — a few dozen
  distinct summaries in practice. Computing a mask walks every vocab
  piece through the machine once per NEW summary (~O(vocab) chars) and
  is cached forever after; steady-state per-step cost is a dict lookup.
  Pieces that would close deeper than the summary records are
  conservatively disallowed (the output stays valid JSON; the model just
  closes one level per token in >3-deep nests).
- The engine applies the mask on the device (``where(mask, logits,
  -inf)`` before sampling) and advances the machine on the host with each
  accepted token (``engine/core.py``); the overlapped engine ships one mask
  per successor state of the token in flight (:meth:`TokenMaskCache.lookahead_groups`)
  and the step picks the row's mask on the device.

Token text comes from ``tokenizer.decode([id])`` per piece; tokenizers
whose single-token decode is lossy (partial UTF-8 fragments render as
replacement chars) get those tokens conservatively disallowed inside
strings only when they decode to the replacement char.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

# Modes.
VALUE = "V"        # expecting a value start
IN_STRING = "S"    # inside a string
STR_ESCAPE = "E"   # after backslash in a string
STR_HEX = "U"      # inside \uXXXX: literal = key-marker + one 'h' per digit left
IN_NUMBER = "N"    # inside a number (last char was part of a number)
AFTER_VALUE = "A"  # a value just completed; expect , } ] or end
EXPECT_KEY = "K"   # inside an object, expecting a key string or }
AFTER_KEY = "C"    # key string done, expecting :
LITERAL = "L"      # partway through true/false/null
REJECT = "X"

_WS = " \t\n\r"
_LITERALS = {"t": "rue", "f": "alse", "n": "ull"}
# RFC 8259 string escapes: exactly these after a backslash; \u is handled
# as its own pending-hex state so it consumes exactly 4 hex digits ('\u12',
# '\uZZZZ' or a bare '\q' must not be accepted — json.loads rejects them).
_ESCAPABLE = set('"\\/bfnrt')
_HEX = set("0123456789abcdefABCDEF")


@dataclasses.dataclass(frozen=True)
class MachineState:
    mode: str = VALUE
    literal: str = ""          # remaining chars of a pending literal
    stack: tuple = ()          # container stack, innermost last: '{' / '['
    # IN_NUMBER only: the number is terminable (has digits, doesn't end in
    # '.', 'e', '+', '-' — "-" or "1e+" must not count as complete).
    num_ok: bool = False
    # VALUE/EXPECT_KEY reached via ',': an immediate closer would produce a
    # trailing comma ('[1,]' / '{"a":1,}'), which is not JSON.
    no_close: bool = False

    @property
    def depth(self) -> int:
        return len(self.stack)

    def summary(self) -> tuple:
        """Bounded cache key: masks computed from equal summaries are equal
        for every piece that closes at most len(kept stack) levels."""
        # min(depth, 4): depth <= 3 states carry their FULL stack (every
        # piece verdict is determined) and must never share a key with
        # deeper states whose 4th-from-top symbol is unrecorded.
        return (self.mode, self.literal, self.stack[-3:], min(self.depth, 4),
                self.num_ok, self.no_close)

    def complete(self) -> bool:
        """The text so far is a COMPLETE JSON value."""
        if self.depth != 0:
            return False
        return self.mode == AFTER_VALUE or (self.mode == IN_NUMBER and self.num_ok)


def advance(state: MachineState, ch: str) -> MachineState:
    """One character step; returns a REJECT-mode state on invalid input."""
    mode, lit, stack = state.mode, state.literal, state.stack

    def st(m, l="", s=stack):
        return MachineState(m, l, s)

    bad = MachineState(REJECT)
    if mode == REJECT:
        return bad
    if mode == IN_STRING:
        if ch == '"':
            # Key strings finish to AFTER_KEY; value strings to AFTER_VALUE.
            return st(AFTER_KEY if lit == "k" else AFTER_VALUE)
        if ch == "\\":
            return st(STR_ESCAPE, lit)
        # RFC 8259: control characters U+0000..U+001F must be escaped.
        return bad if ord(ch) < 0x20 else st(IN_STRING, lit)
    if mode == STR_ESCAPE:
        if ch == "u":
            return st(STR_HEX, lit + "hhhh")
        return st(IN_STRING, lit) if ch in _ESCAPABLE else bad
    if mode == STR_HEX:
        if ch not in _HEX:
            return bad
        rest = lit[:-1]  # one pending hex digit consumed
        return st(STR_HEX, rest) if rest.endswith("h") else st(IN_STRING, rest)
    if mode == LITERAL:
        if lit and ch == lit[0]:
            return st(AFTER_VALUE) if len(lit) == 1 else st(LITERAL, lit[1:])
        return bad
    if mode == IN_NUMBER:
        # Full JSON number grammar; phase rides in ``literal``:
        # sign -> (zero | int) -> [frac0 -> frac] -> [exp0 -> exp1? -> exp]
        ph = lit

        def num(phase, ok):
            return MachineState(IN_NUMBER, phase, stack, num_ok=ok)

        if ph == "sign":
            if ch == "0":
                return num("zero", True)
            return num("int", True) if ch.isdigit() else bad
        if ph in ("zero", "int", "frac", "exp"):
            if ch.isdigit():
                if ph == "zero":
                    return bad  # leading-zero rule: "01" is not JSON
                return num(ph, True)
            if ch == "." and ph in ("zero", "int"):
                return num("frac0", False)
            if ch in "eE" and ph in ("zero", "int", "frac"):
                return num("exp0", False)
            # Delimiter ends a terminable number (reinterpreted from
            # AFTER_VALUE); "-," / "1e+," are not JSON.
            return advance(st(AFTER_VALUE), ch) if state.num_ok else bad
        if ph == "frac0":
            return num("frac", True) if ch.isdigit() else bad
        if ph == "exp0":
            if ch in "+-":
                return num("exp1", False)
            return num("exp", True) if ch.isdigit() else bad
        if ph == "exp1":
            return num("exp", True) if ch.isdigit() else bad
        return bad
    if mode == VALUE:
        if ch in _WS:
            return state
        if ch == '"':
            return st(IN_STRING)
        if ch == "-":
            return MachineState(IN_NUMBER, "sign", stack, num_ok=False)
        if ch == "0":
            return MachineState(IN_NUMBER, "zero", stack, num_ok=True)
        if ch in "123456789":
            return MachineState(IN_NUMBER, "int", stack, num_ok=True)
        if ch in _LITERALS:
            return st(LITERAL, _LITERALS[ch])
        if ch == "{":
            return MachineState(EXPECT_KEY, "", stack + ("{",))
        if ch == "[":
            return MachineState(VALUE, "", stack + ("[",))
        if ch == "]" and stack and stack[-1] == "[" and not state.no_close:
            # Empty array closes straight from VALUE (but not right after a
            # comma — '[1,]' is not JSON).
            return MachineState(AFTER_VALUE, "", stack[:-1])
        return bad
    if mode == EXPECT_KEY:
        if ch in _WS:
            return state
        if ch == '"':
            return st(IN_STRING, "k")
        if ch == "}" and stack and stack[-1] == "{" and not state.no_close:
            return MachineState(AFTER_VALUE, "", stack[:-1])
        return bad
    if mode == AFTER_KEY:
        if ch in _WS:
            return state
        return st(VALUE) if ch == ":" else bad
    if mode == AFTER_VALUE:
        if ch in _WS:
            return state
        if ch == "," and stack:
            return MachineState(
                EXPECT_KEY if stack[-1] == "{" else VALUE, "", stack, no_close=True
            )
        if ch == "}" and stack and stack[-1] == "{":
            return MachineState(AFTER_VALUE, "", stack[:-1])
        if ch == "]" and stack and stack[-1] == "[":
            return MachineState(AFTER_VALUE, "", stack[:-1])
        return bad
    return bad


def advance_text(state: MachineState, text: str) -> MachineState:
    for ch in text:
        state = advance(state, ch)
        if state.mode == REJECT:
            return state
    return state


def advance_text_tracked(state: MachineState, text: str) -> tuple[MachineState, int]:
    """Like :func:`advance_text`, also returning the MINIMUM stack depth
    touched — a piece whose simulation dips below the depths the summary
    records consulted stack symbols the cache key doesn't know about, so
    its verdict must not be cached for that summary."""
    min_depth = state.depth
    for ch in text:
        state = advance(state, ch)
        if state.mode == REJECT:
            return state, min_depth
        min_depth = min(min_depth, state.depth)
    return state, min_depth


#: A piece per closing token used by force-close (one level per step).
_CLOSERS = {"{": "}", "[": "]"}


# ---------------------------------------------------------------------------
# Vectorized mask builder
#
# The pure-Python builder walks every vocab piece through ``advance`` char by
# char — ~0.4 s per cold summary at a 128k vocab, which caps chained
# JSON-mode traffic at exactly the vocab sizes production models use. The
# machine's per-piece state is finite and small (mode enum, one of ~27
# literal/phase strings, a relative stack depth, a handful of flags), so the
# whole vocab can be simulated COLUMN-WISE as numpy array ops: one pass over
# ``max_piece_len`` columns updates every piece's machine in lockstep. The
# result (mask, close budgets, transition descriptors) is bitwise identical
# to the Python builder's; DYN_CONSTRAINT_VECTOR_MASKS=0 falls back.
# ---------------------------------------------------------------------------

# Mode ids (np.int8 enum mirroring the single-char mode constants).
_M_V, _M_S, _M_E, _M_U, _M_N, _M_A, _M_K, _M_C, _M_L, _M_X = range(10)
_MODE_ID = {VALUE: _M_V, IN_STRING: _M_S, STR_ESCAPE: _M_E, STR_HEX: _M_U,
            IN_NUMBER: _M_N, AFTER_VALUE: _M_A, EXPECT_KEY: _M_K,
            AFTER_KEY: _M_C, LITERAL: _M_L, REJECT: _M_X}
_MODE_STR = {v: k for k, v in _MODE_ID.items()}

# Every value MachineState.literal can hold: the empty/key markers, literal
# tails, pending-hex chains (value and key strings), and number phases.
_LIT_STRINGS = (
    "", "k",
    "rue", "ue", "e", "alse", "lse", "se", "ull", "ll", "l",
    "hhhh", "hhh", "hh", "h", "khhhh", "khhh", "khh", "kh",
    "sign", "zero", "int", "frac0", "frac", "exp0", "exp1", "exp",
)
_LIT_ID = {s: i for i, s in enumerate(_LIT_STRINGS)}
_NLIT = len(_LIT_STRINGS)

# LITERAL mode: expected next char code and successor lit id (-1 = literal
# complete -> AFTER_VALUE).
_LIT_EXPECT = np.zeros(_NLIT, np.int32)
_LIT_NEXT = np.full(_NLIT, -1, np.int8)
for _s in ("rue", "ue", "e", "alse", "lse", "se", "ull", "ll", "l"):
    _LIT_EXPECT[_LIT_ID[_s]] = ord(_s[0])
    _LIT_NEXT[_LIT_ID[_s]] = _LIT_ID.get(_s[1:], -1) if len(_s) > 1 else -1
# STR_HEX chains: one hex digit consumed -> lit[:-1]; stay in STR_HEX while
# the rest still ends in 'h', else back to IN_STRING with "" / "k".
_HEX_NEXT = np.zeros(_NLIT, np.int8)
_HEX_STAY = np.zeros(_NLIT, bool)
for _s in ("hhhh", "hhh", "hh", "h", "khhhh", "khhh", "khh", "kh"):
    _rest = _s[:-1]
    _HEX_NEXT[_LIT_ID[_s]] = _LIT_ID[_rest]
    _HEX_STAY[_LIT_ID[_s]] = _rest.endswith("h")
# STR_ESCAPE '\u': lit ("" or "k") gains four pending hex digits.
_ESC_U_NEXT = np.zeros(_NLIT, np.int8)
_ESC_U_NEXT[_LIT_ID[""]] = _LIT_ID["hhhh"]
_ESC_U_NEXT[_LIT_ID["k"]] = _LIT_ID["khhhh"]
# budget_to_close lookups: literal length, pending hex digits, key marker.
_LIT_LEN = np.array([len(s) for s in _LIT_STRINGS], np.int16)
_LIT_HCOUNT = np.array([s.count("h") for s in _LIT_STRINGS], np.int16)
_LIT_ISKEY = np.array([s.startswith("k") for s in _LIT_STRINGS], bool)

# Char property bits. ASCII from the table below; non-ASCII chars carry
# only _P_UDIG (``str.isdigit()`` — the Python machine's number phases use
# it, so e.g. Arabic-Indic digits advance IN_NUMBER exactly as they do
# there; everything else is plain string content matching no structural
# char).
_P_WS, _P_DIG19, _P_ZERO, _P_HEX, _P_ESC, _P_CTRL, _P_UDIG = 1, 2, 4, 8, 16, 32, 64
_PROPS = np.zeros(128, np.uint8)
for _c in _WS:
    _PROPS[ord(_c)] |= _P_WS
for _c in "123456789":
    _PROPS[ord(_c)] |= _P_DIG19
_PROPS[ord("0")] |= _P_ZERO
for _c in "0123456789abcdefABCDEF":
    _PROPS[ord(_c)] |= _P_HEX
for _c in _ESCAPABLE:
    _PROPS[ord(_c)] |= _P_ESC
_PROPS[:0x20] |= _P_CTRL
for _c in "0123456789":
    _PROPS[ord(_c)] |= _P_UDIG

_SYM_ID = {"{": 1, "[": 2}
_SYM_STR = {1: "{", 2: "["}

# Number phase lit-id groups (IN_NUMBER rides its phase in ``literal``).
_PH_SIGN, _PH_ZERO, _PH_INT = _LIT_ID["sign"], _LIT_ID["zero"], _LIT_ID["int"]
_PH_FRAC0, _PH_FRAC = _LIT_ID["frac0"], _LIT_ID["frac"]
_PH_EXP0, _PH_EXP1, _PH_EXP = _LIT_ID["exp0"], _LIT_ID["exp1"], _LIT_ID["exp"]
_PH_CORE = np.zeros(_NLIT, bool)  # zero|int|frac|exp: digit-extensible
for _p in (_PH_ZERO, _PH_INT, _PH_FRAC, _PH_EXP):
    _PH_CORE[_p] = True
_PH_DOT_OK = np.zeros(_NLIT, bool)  # '.' legal: zero|int
_PH_DOT_OK[_PH_ZERO] = _PH_DOT_OK[_PH_INT] = True
_PH_EXP_OK = np.zeros(_NLIT, bool)  # e|E legal: zero|int|frac
_PH_EXP_OK[_PH_ZERO] = _PH_EXP_OK[_PH_INT] = _PH_EXP_OK[_PH_FRAC] = True

# Mode-keyed budget_to_close extras (IN_NUMBER/STR_HEX/LITERAL handled
# separately — they depend on lit/num_ok).
_MODE_EXTRA = np.zeros(10, np.int16)
for _m, _x in ((_M_S, 1), (_M_E, 2), (_M_C, 2), (_M_V, 1), (_M_K, 1)):
    _MODE_EXTRA[_m] = _x


class _VocabTable:
    """Per-tokenizer piece descriptors for the vectorized builder: a padded
    char-code matrix plus per-char ASCII property bits, built once."""

    def __init__(self, pieces: list[str]) -> None:
        V = len(pieces)
        lens = np.fromiter((len(p) for p in pieces), np.int32, count=V)
        maxlen = int(lens.max()) if V else 0
        codes = np.full((V, max(maxlen, 1)), -1, np.int32)
        for t, p in enumerate(pieces):
            if p:
                codes[t, : len(p)] = np.frombuffer(p.encode("utf-32-le"), "<u4")
        props = np.zeros_like(codes, np.uint8)
        ascii_mask = (codes >= 0) & (codes < 128)
        props[ascii_mask] = _PROPS[codes[ascii_mask]]
        hi = codes >= 128
        if hi.any():
            uniq = np.unique(codes[hi])
            udig = np.fromiter(
                (chr(int(u)).isdigit() for u in uniq), bool, count=uniq.size
            )
            props[hi] |= np.where(
                udig[np.searchsorted(uniq, codes[hi])], _P_UDIG, 0
            ).astype(np.uint8)
        self.lens = lens
        self.codes = codes
        self.props = props
        self.maxlen = maxlen
        self.empty = lens == 0
        self.has_replacement = (codes == 0xFFFD).any(axis=1)


def _simulate_vocab(state: MachineState, tab: _VocabTable):
    """Run every vocab piece through the machine in lockstep.

    Returns ``(mode, lit, rel, minrel, num_ok, no_close, buf)`` final
    arrays; ``buf[t, s]`` is piece ``t``'s current stack symbol at relative
    depth ``s - 3`` (slots 0-2 pre-seeded with the summary's recorded
    ``stack[-3:]``, 0 = no symbol), so ``buf[t, minrel+3 : rel+3]`` is
    exactly ``ns.stack[min_depth:]``. Pieces are REJECTed (mode X) exactly
    when the Python machine rejects them, plus — for depth > 3 states —
    when they dip below the recorded stack suffix (the soundness floor
    would disallow them anyway, and early kill keeps slot indices valid).
    """
    V, width = tab.codes.shape
    depth0 = state.depth
    deep = depth0 > 3
    mode = np.full(V, _MODE_ID[state.mode], np.int8)
    lit = np.full(V, _LIT_ID[state.literal], np.int8)
    rel = np.zeros(V, np.int16)
    minrel = np.zeros(V, np.int16)
    num_ok = np.full(V, state.num_ok, bool)
    no_close = np.full(V, state.no_close, bool)
    buf = np.zeros((V, width + 3), np.uint8)
    base = state.stack[-3:]
    for i, sym in enumerate(base):
        buf[:, 3 - len(base) + i] = _SYM_ID[sym]

    Q, BSL, LB, RB, LK, RK = ord('"'), ord("\\"), ord("{"), ord("}"), ord("["), ord("]")
    COMMA, COLON, MINUS, PLUS, DOT = ord(","), ord(":"), ord("-"), ord("+"), ord(".")
    ZERO, LE, UE, LU = ord("0"), ord("e"), ord("E"), ord("u")
    LT, LF, LN = ord("t"), ord("f"), ord("n")

    # The column loop runs COMPACTED: ``idx`` holds the still-live row ids
    # (piece long enough, not REJECTed) and every block operates on arrays
    # of ``idx.size``. Rejections shrink the working set fast (a cold build
    # in a structural mode kills most of a random vocab in the first one
    # or two columns), so later columns cost almost nothing. ``m``/``l``/
    # ``nk``/``nc`` are the compact views, scattered back each column;
    # ``rel``/``minrel``/``buf`` are touched by few rows (pushes/pops) and
    # stay full-width, indexed through ``idx``.
    live = np.flatnonzero(tab.lens > 0)
    for j in range(tab.maxlen):
        if j:
            live = live[(tab.lens[live] > j) & (mode[live] != _M_X)]
        if live.size == 0:
            break
        idx = live
        m = mode[idx]
        l = lit[idx]
        nk = num_ok[idx]
        nc = no_close[idx]
        c = tab.codes[idx, j]
        p = tab.props[idx, j]
        ws = (p & _P_WS) != 0
        todo = np.ones(idx.size, bool)

        def pop_rows(rows):
            """Pop one level for compact positions ``rows`` (top already
            verified) -> AFTER_VALUE with default flags."""
            g = idx[rows]
            rel[g] -= 1
            minrel[g] = np.minimum(minrel[g], rel[g])
            m[rows] = _M_A
            l[rows] = 0
            nk[rows] = False
            nc[rows] = False
            if deep:
                m[rows[rel[g] < -2]] = _M_X  # below the recorded suffix

        def top_of(rows):
            """Current stack-top symbol per compact position (0 = empty)."""
            g = idx[rows]
            r = rel[g]
            t = buf[g, np.maximum(r + 2, 0)]
            return np.where(depth0 + r > 0, t, 0)

        # IN_STRING: '"' ends (key -> AFTER_KEY), '\' escapes, control
        # dies; every step is a fresh st(...) so both flags reset.
        sel = todo & (m == _M_S)
        if sel.any():
            q = sel & (c == Q)
            m[q] = np.where(l[q] == _LIT_ID["k"], _M_C, _M_A).astype(np.int8)
            l[q] = 0
            m[sel & (c == BSL)] = _M_E
            m[sel & ((p & _P_CTRL) != 0)] = _M_X
            nk[sel] = False
            nc[sel] = False
            todo[sel] = False

        # STR_ESCAPE: 'u' starts a hex run, escapables return to the string.
        sel = todo & (m == _M_E)
        if sel.any():
            u = sel & (c == LU)
            l[u] = _ESC_U_NEXT[l[u]]
            m[u] = _M_U
            m[sel & ~u & ((p & _P_ESC) != 0)] = _M_S
            m[sel & ~u & ((p & _P_ESC) == 0)] = _M_X
            nk[sel] = False
            nc[sel] = False
            todo[sel] = False

        # STR_HEX: consume one pending digit; non-hex dies.
        sel = todo & (m == _M_U)
        if sel.any():
            hx = sel & ((p & _P_HEX) != 0)
            stay = _HEX_STAY[l[hx]]
            nxt = _HEX_NEXT[l[hx]]
            m[hx] = np.where(stay, _M_U, _M_S).astype(np.int8)
            l[hx] = nxt
            m[sel & ~hx] = _M_X
            nk[sel] = False
            nc[sel] = False
            todo[sel] = False

        # LITERAL: exact-char chain; completion -> AFTER_VALUE.
        sel = todo & (m == _M_L)
        if sel.any():
            exp = _LIT_EXPECT[l]
            hit = sel & (c == exp) & (exp != 0)  # exp 0: empty lit, no match
            nxt = _LIT_NEXT[l[hit]]
            m[hit] = np.where(nxt < 0, _M_A, _M_L).astype(np.int8)
            l[hit] = np.maximum(nxt, 0)
            m[sel & ~hit] = _M_X
            nk[sel] = False
            nc[sel] = False
            todo[sel] = False

        # IN_NUMBER: phase grammar; a delimiter on a terminable number
        # re-dispatches through AFTER_VALUE *in this same column* (the rows
        # stay on the todo list and the AFTER_VALUE block below picks them
        # up), matching advance()'s recursive re-interpretation.
        sel = todo & (m == _M_N)
        if sel.any():
            # Every legacy num() construction leaves no_close at its default.
            nc[sel] = False
            isdig = (p & (_P_DIG19 | _P_ZERO | _P_UDIG)) != 0
            s_sign = sel & (l == _PH_SIGN)
            if s_sign.any():
                z = s_sign & (c == ZERO)
                l[z] = _PH_ZERO
                nk[z] = True
                d = s_sign & isdig & (c != ZERO)
                l[d] = _PH_INT
                nk[d] = True
                m[s_sign & ~isdig] = _M_X
                todo[s_sign] = False
            core = sel & _PH_CORE[l] & todo
            if core.any():
                m[core & isdig & (l == _PH_ZERO)] = _M_X  # "01" is not JSON
                nk[core & isdig & (l != _PH_ZERO)] = True
                dot = core & (c == DOT) & _PH_DOT_OK[l]
                l[dot] = _PH_FRAC0
                nk[dot] = False
                ee = core & ((c == LE) | (c == UE)) & _PH_EXP_OK[l]
                l[ee] = _PH_EXP0
                nk[ee] = False
                delim = core & ~isdig & ~dot & ~ee
                m[delim & ~nk] = _M_X
                redo = delim & nk
                m[redo] = _M_A
                l[redo] = 0
                nk[redo] = False
                nc[redo] = False
                todo[core] = False
                todo[redo] = True  # AFTER_VALUE reprocesses this char below
            f0 = sel & (l == _PH_FRAC0) & todo
            if f0.any():
                d = f0 & isdig
                l[d] = _PH_FRAC
                nk[d] = True
                m[f0 & ~isdig] = _M_X
                todo[f0] = False
            e0 = sel & (l == _PH_EXP0) & todo
            if e0.any():
                pm = e0 & ((c == PLUS) | (c == MINUS))
                l[pm] = _PH_EXP1
                nk[pm] = False
                d = e0 & isdig
                l[d] = _PH_EXP
                nk[d] = True
                m[e0 & ~isdig & ~pm] = _M_X
                todo[e0] = False
            e1 = sel & (l == _PH_EXP1) & todo
            if e1.any():
                d = e1 & isdig
                l[d] = _PH_EXP
                nk[d] = True
                m[e1 & ~isdig] = _M_X
                todo[e1] = False

        # AFTER_VALUE: WS stays (state untouched), ',' reopens (no_close
        # set), closers pop.
        sel = todo & (m == _M_A)
        if sel.any():
            todo[sel & ws] = False
            sel &= ~ws
            if sel.any():
                rows = np.flatnonzero(sel)
                top = top_of(rows)
                ch = c[rows]
                comma = (ch == COMMA) & (top != 0)
                cr = rows[comma]
                m[cr] = np.where(top[comma] == 1, _M_K, _M_V).astype(np.int8)
                l[cr] = 0
                nk[cr] = False
                nc[cr] = True
                popm = ((ch == RB) & (top == 1)) | ((ch == RK) & (top == 2))
                pop_rows(rows[popm])
                m[rows[~comma & ~popm]] = _M_X
                todo[sel] = False

        # VALUE: value starts, '[' / '{' pushes, ']' closes an empty array.
        sel = todo & (m == _M_V)
        if sel.any():
            todo[sel & ws] = False
            sel &= ~ws
            if sel.any():
                q = sel & (c == Q)
                m[q] = _M_S
                l[q] = 0
                nk[q] = False
                nc[q] = False
                mi = sel & (c == MINUS)
                m[mi] = _M_N
                l[mi] = _PH_SIGN
                nk[mi] = False
                nc[mi] = False
                z = sel & (c == ZERO)
                m[z] = _M_N
                l[z] = _PH_ZERO
                nk[z] = True
                nc[z] = False
                d = sel & ((p & _P_DIG19) != 0)
                m[d] = _M_N
                l[d] = _PH_INT
                nk[d] = True
                nc[d] = False
                handled = q | mi | z | d
                for code, tail in ((LT, "rue"), (LF, "alse"), (LN, "ull")):
                    li = sel & (c == code)
                    m[li] = _M_L
                    l[li] = _LIT_ID[tail]
                    nk[li] = False
                    nc[li] = False
                    handled |= li
                for code, tgt, sym in ((LB, _M_K, 1), (LK, _M_V, 2)):
                    op = sel & (c == code)
                    if op.any():
                        rows = np.flatnonzero(op)
                        g = idx[rows]
                        buf[g, rel[g] + 3] = sym
                        rel[g] += 1
                        m[rows] = tgt
                        l[rows] = 0
                        nk[rows] = False
                        nc[rows] = False
                    handled |= op
                cl = sel & (c == RK) & ~nc
                if cl.any():
                    rows = np.flatnonzero(cl)
                    okt = top_of(rows) == 2
                    pop_rows(rows[okt])
                    m[rows[~okt]] = _M_X
                handled |= cl
                m[sel & ~handled] = _M_X  # incl. ']' right after a comma
                todo[sel] = False

        # EXPECT_KEY: key string or '}' (unless just after a comma).
        sel = todo & (m == _M_K)
        if sel.any():
            todo[sel & ws] = False
            sel &= ~ws
            if sel.any():
                q = sel & (c == Q)
                m[q] = _M_S
                l[q] = _LIT_ID["k"]
                nk[q] = False
                nc[q] = False
                cl = sel & (c == RB) & ~nc
                if cl.any():
                    rows = np.flatnonzero(cl)
                    okt = top_of(rows) == 1
                    pop_rows(rows[okt])
                    m[rows[~okt]] = _M_X
                m[sel & ~q & ~cl] = _M_X  # incl. '}' right after a comma
                todo[sel] = False

        # AFTER_KEY: only ':'.
        sel = todo & (m == _M_C)
        if sel.any():
            todo[sel & ws] = False
            sel &= ~ws
            if sel.any():
                col = sel & (c == COLON)
                m[col] = _M_V
                l[col] = 0
                nk[col] = False
                nc[col] = False
                m[sel & ~col] = _M_X
                todo[sel] = False

        mode[idx] = m
        lit[idx] = l
        num_ok[idx] = nk
        no_close[idx] = nc

    return mode, lit, rel, minrel, num_ok, no_close, buf


def _vector_masks_enabled() -> bool:
    """DYN_CONSTRAINT_VECTOR_MASKS=0 falls back to the pure-Python builder
    (escape hatch; outputs are bitwise identical, only build time differs)."""
    return os.environ.get("DYN_CONSTRAINT_VECTOR_MASKS", "1") != "0"


class TokenMaskCache:
    """Per-tokenizer vocab masks keyed by machine summary."""

    def __init__(self, tokenizer, vocab_size: int, eos_ids: tuple[int, ...]) -> None:
        import threading

        self.vocab_size = vocab_size
        self.eos_ids = tuple(eos_ids)
        self._pieces: list[str] | None = None
        self._tok = tokenizer
        self._masks: dict[tuple, np.ndarray] = {}
        # Per-summary transition table built alongside each mask: for every
        # admitted piece, a small descriptor of the machine's state change
        # (summary -> (desc_id i32[vocab], [descriptor, ...])). Lets the
        # overlapped engine reconstruct the EXACT successor state of any
        # allowed token without re-walking its piece — the one-step-lookahead
        # mask precompute groups candidate tokens by descriptor.
        self._descs: dict[tuple, tuple[np.ndarray, list]] = {}
        self._close_ids: dict[str, int | None] = {}
        # Cache-lookup counters (mirrored to the metrics plane as
        # dynamo_engine_constraint_mask_cache_{hits,misses}_total): a miss is
        # a lookup the cache could not answer warm — a cold mask build, or a
        # peek/lookahead that had to decline (the overlapped engine then
        # barriers with reason constraint_miss and the sync fallback warms
        # the summary).
        self.hits = 0
        self.misses = 0
        # Per-tokenizer piece descriptor arrays for the vectorized builder,
        # computed lazily on the first cold build.
        self._table: _VocabTable | None = None
        # Wall-clock seconds of each cold mask build since the last drain;
        # the metrics plane observes these into the
        # dynamo_engine_constraint_mask_build_seconds histogram.
        self._build_seconds: list[float] = []
        # Serializes the seconds-long cold builds (piece table, per-summary
        # vocab walks): the warm-up thread and a racing request must not
        # duplicate them, and the second comer blocks instead of recomputing.
        self._build_lock = threading.Lock()

    def _ensure_pieces(self) -> list[str]:
        if self._pieces is None:
            with self._build_lock:
                if self._pieces is None:
                    dec = self._tok.decode
                    self._pieces = [
                        dec([t], skip_special_tokens=False) for t in range(self.vocab_size)
                    ]
        return self._pieces

    def mask_for(self, state: MachineState, *, force_close: bool = False,
                 remaining: int | None = None) -> np.ndarray:
        """bool[vocab]: tokens that keep the output a valid JSON prefix.

        ``force_close``: remaining budget is nearly exhausted — restrict to
        tokens that strictly make progress toward closing (closers, the
        string terminator, escapes' completion), so the response parses
        when it finishes.

        ``remaining``: token budget left — pieces whose resulting state
        cannot be closed within it are excluded (a single BPE token like
        '[[[[' opens four levels; admitting it just above the force-close
        threshold would make the close unaffordable and truncate mid-JSON).
        """
        if force_close:
            return self._force_close_mask(state)
        allowed, close_rel = self._base_mask(state)
        if remaining is not None:
            allowed = allowed & (close_rel + state.depth <= max(remaining - 1, 1))
            if not allowed.any():
                return self._force_close_mask(state)
        return self._finalize(allowed, state)

    def _base_mask(self, state: MachineState) -> tuple[np.ndarray, np.ndarray]:
        """(allowed bool[vocab], budget_to_close after each piece i16[vocab])
        for a machine summary. Sound under the bounded summary: a piece
        whose simulation dips below the recorded stack suffix (min depth <
        depth - 3) is conservatively disallowed — its verdict would depend
        on symbols the cache key doesn't carry."""
        key = state.summary()
        cached = self._masks.get(key)
        if cached is not None:
            self.hits += 1
            return cached
        pieces = self._ensure_pieces()
        with self._build_lock:
            cached = self._masks.get(key)  # built while we waited?
            if cached is not None:
                self.hits += 1
                return cached
            self.misses += 1
            return self._build_mask(state, key, pieces)

    def _build_mask(self, state: MachineState, key: tuple, pieces) -> tuple[np.ndarray, np.ndarray]:
        """Cold build (caller holds ``_build_lock``): dispatch to the
        vectorized builder, timing the build for the metrics histogram."""
        t0 = time.perf_counter()
        if _vector_masks_enabled():
            out = self._build_mask_vectorized(state, key, pieces)
        else:
            out = self._build_mask_python(state, key, pieces)
        self._build_seconds.append(time.perf_counter() - t0)
        return out

    def drain_build_seconds(self) -> list[float]:
        """Cold-build durations since the last drain (metrics scrape path)."""
        out, self._build_seconds = self._build_seconds, []
        return out

    def _vocab_table(self) -> _VocabTable:
        # Only reached from _build_mask (under _build_lock) AFTER _base_mask
        # materialized the pieces, so _ensure_pieces returns without trying
        # to re-take the (non-reentrant) lock.
        if self._table is None:
            self._table = _VocabTable(self._ensure_pieces())
        return self._table

    def _build_mask_vectorized(
        self, state: MachineState, key: tuple, pieces
    ) -> tuple[np.ndarray, np.ndarray]:
        """Column-wise numpy simulation of the whole vocab; outputs are
        bitwise identical to :meth:`_build_mask_python` (the parity suite in
        tests/test_constrained.py checks masks, close budgets, descriptor
        ids AND decoded descriptors across a summary corpus)."""
        tab = self._vocab_table()
        mode, lit, rel, minrel, num_ok, no_close, buf = _simulate_vocab(state, tab)
        # Admission: the simulation already REJECTs every piece the Python
        # machine rejects, and (deep states) every piece dipping below the
        # recorded stack suffix — exactly the soundness floor. Empty pieces
        # and lossy-decode pieces mirror the Python builder's skips.
        allowed = (mode != _M_X) & ~tab.empty
        if state.mode in (IN_STRING, STR_ESCAPE, STR_HEX, VALUE, EXPECT_KEY):
            allowed &= ~tab.has_replacement
        # budget_to_close(ns) - state.depth, computed in the same override
        # order as the scalar method (mode extra -> hex -> key-string ->
        # unterminable number -> post-comma EXPECT_KEY).
        extra = _MODE_EXTRA[mode].astype(np.int32)
        isL = mode == _M_L
        extra[isL] = _LIT_LEN[lit[isL]]
        isU = mode == _M_U
        extra[isU] = _LIT_HCOUNT[lit[isU]] + 1
        keystr = ((mode == _M_S) | (mode == _M_E) | (mode == _M_U)) & _LIT_ISKEY[lit]
        extra[keystr] += 2
        badnum = (mode == _M_N) & ~num_ok
        extra[badnum] = 1
        kc = (mode == _M_K) & no_close
        extra[kc] = 5
        close = np.minimum(rel.astype(np.int32) + extra + 1, 2**14)
        close_after = np.where(allowed, close, 0).astype(np.int16)
        # Transition descriptors: dedup admitted pieces on fixed-width byte
        # records of (mode, literal, min rel depth, flags, stack slice), with
        # ids assigned in FIRST-OCCURRENCE (= token) order so they match the
        # Python builder's incremental numbering exactly.
        desc_ids = np.full(self.vocab_size, -1, np.int32)
        descs: list[tuple] = []
        tok = np.flatnonzero(allowed)
        if tok.size:
            width = buf.shape[1]
            slot = np.arange(width)[None, :]
            mb = buf[tok]
            keep = (slot >= minrel[tok, None] + 3) & (slot < rel[tok, None] + 3)
            mb = np.where(keep, mb, 0)
            rec = np.empty((tok.size, 5 + width), np.uint8)
            rec[:, 0] = mode[tok]
            rec[:, 1] = lit[tok]
            rec[:, 2] = (minrel[tok] + 3).astype(np.uint8)
            rec[:, 3] = num_ok[tok]
            rec[:, 4] = no_close[tok]
            rec[:, 5:] = mb
            rec = np.ascontiguousarray(rec)
            flat = rec.view(np.dtype((np.void, rec.shape[1]))).ravel()
            _, first_idx, inv = np.unique(flat, return_index=True, return_inverse=True)
            order = np.argsort(first_idx, kind="stable")
            rank = np.empty(order.size, np.int32)
            rank[order] = np.arange(order.size, dtype=np.int32)
            desc_ids[tok] = rank[inv]
            for g in range(order.size):
                r = rec[first_idx[order[g]]]
                body = r[5:]
                pushed = tuple(_SYM_STR[int(s)] for s in body[body != 0])
                descs.append((
                    _MODE_STR[int(r[0])], _LIT_STRINGS[int(r[1])],
                    int(r[2]) - 3, pushed, bool(r[3]), bool(r[4]),
                ))
        self._masks[key] = (allowed, close_after)
        self._descs[key] = (desc_ids, descs)
        return allowed, close_after

    def _build_mask_python(self, state: MachineState, key: tuple, pieces) -> tuple[np.ndarray, np.ndarray]:
        allowed = np.zeros(self.vocab_size, bool)
        close_after = np.zeros(self.vocab_size, np.int16)
        desc_ids = np.full(self.vocab_size, -1, np.int32)
        descs: list[tuple] = []
        desc_index: dict[tuple, int] = {}
        # Soundness floor: with depth <= 3 the summary records the WHOLE
        # stack, so the machine's own verdict is exact. Deeper states may
        # only admit pieces whose every stack consult (pop / ',' / closer
        # match, each reading the top at sim depth s = index s-1) touches a
        # recorded symbol: indices >= depth-3, i.e. sim depth stays
        # >= depth-2 throughout.
        floor = 0 if state.depth <= 3 else state.depth - 2
        for t, piece in enumerate(pieces):
            if not piece:
                continue
            if "�" in piece and state.mode in (IN_STRING, STR_ESCAPE, STR_HEX, VALUE, EXPECT_KEY):
                continue  # lossy single-token decode: keep strings clean
            ns, min_depth = advance_text_tracked(state, piece)
            if ns.mode != REJECT and min_depth >= floor:
                allowed[t] = True
                # Depth-RELATIVE: states deeper than the summary cap share
                # this entry; the caller adds its own depth back.
                close_after[t] = min(self.budget_to_close(ns) - state.depth, 2**14)
                # Transition descriptor, depth-relative like close_after.
                # The floor guarantees the simulation only consulted
                # recorded stack symbols, so any state sharing this summary
                # reaches the same (rel, pushed) — its successor stack is
                # stack[: depth + rel] + pushed exactly.
                d = (ns.mode, ns.literal, min_depth - state.depth,
                     ns.stack[min_depth:], ns.num_ok, ns.no_close)
                g = desc_index.get(d)
                if g is None:
                    g = desc_index[d] = len(descs)
                    descs.append(d)
                desc_ids[t] = g
        self._masks[key] = (allowed, close_after)
        self._descs[key] = (desc_ids, descs)
        return allowed, close_after

    def _finalize(self, base: np.ndarray, state: MachineState) -> np.ndarray:
        out = base.copy()
        complete = state.complete()
        for e in self.eos_ids:
            if 0 <= e < self.vocab_size:
                out[e] = complete  # EOS exactly when the JSON is complete
        return out

    def _closer_token(self, piece: str) -> int | None:
        if piece not in self._close_ids:
            pieces = self._ensure_pieces()
            self._close_ids[piece] = next(
                (t for t, p in enumerate(pieces) if p == piece), None
            )
        return self._close_ids[piece]

    def _force_close_mask(self, state: MachineState) -> np.ndarray:
        out = np.zeros(self.vocab_size, bool)
        if state.complete():
            for e in self.eos_ids:
                if 0 <= e < self.vocab_size:
                    out[e] = True
            if not out.any():
                # No EOS in this vocab: nothing to force — the ENGINE ends
                # completed json_mode sequences itself (a zero-allowed mask
                # would send the sampler into arbitrary tokens).
                return self.mask_for(state)
            return out
        want: str | None = None
        if state.mode in (IN_STRING, STR_ESCAPE, STR_HEX):
            # IN_STRING: terminate; STR_ESCAPE: finish the escape minimally;
            # STR_HEX: feed hex digits until the 4 are consumed.
            want = {IN_STRING: '"', STR_ESCAPE: "n", STR_HEX: "0"}[state.mode]
        elif state.mode == AFTER_KEY:
            want = ":"
        elif state.mode == VALUE:
            # Close an empty array where legal; otherwise produce a value.
            if state.stack and state.stack[-1] == "[" and not state.no_close:
                want = "]"
            else:
                want = "0"
        elif state.mode == LITERAL:
            want = state.literal[0] if state.literal else None
        elif state.mode == EXPECT_KEY:
            want = '"' if state.no_close else "}"
        elif state.mode == IN_NUMBER and not state.num_ok:
            want = "0"
        elif state.mode in (AFTER_VALUE, IN_NUMBER) and state.stack:
            want = _CLOSERS[state.stack[-1]]
        if want is not None:
            tid = self._closer_token(want)
            if tid is not None:
                out[tid] = True
        if not out.any():
            # No single-char closing token in this vocab: fall back to the
            # unconstrained-valid mask rather than deadlocking the sampler.
            return self.mask_for(state)
        return out

    def budget_to_close(self, state: MachineState) -> int:
        """Upper bound on tokens needed to reach a complete JSON value by
        single-char force-close steps."""
        extra = {IN_STRING: 1, STR_ESCAPE: 2, AFTER_KEY: 2, VALUE: 1,
                 EXPECT_KEY: 1, LITERAL: len(state.literal)}.get(state.mode, 0)
        if state.mode == STR_HEX:
            extra = state.literal.count("h") + 1  # pending hex digits + '"'
        if state.mode in (IN_STRING, STR_ESCAPE, STR_HEX) and state.literal.startswith("k"):
            extra += 2  # key string: the closing '"' lands in AFTER_KEY, so
            #             ':' + a one-char value must still fit
        if state.mode == IN_NUMBER and not state.num_ok:
            extra = 1  # one digit terminates any incomplete number phase
        if state.mode == EXPECT_KEY and state.no_close:
            extra = 5  # '"' + '"' + ':' + value before the '}' can come
        return state.depth + extra + 1  # +1 for EOS

    # ---- one-step lookahead (overlapped engine) ------------------------
    #
    # The overlapped pipeline composes step N+1 while step N's token is
    # still on device. These peek-only entry points let the engine (a)
    # recompute the mask the in-flight step samples under and (b) group
    # every candidate token it can emit by exact successor state — WITHOUT
    # ever paying a cold O(vocab) build on the dispatch path. A cold
    # summary returns None; the engine barriers (reason constraint_miss),
    # the sync fallback builds the mask, and the next step chains warm.

    def peek_mask(self, state: MachineState, remaining: int) -> np.ndarray | None:
        """:meth:`JsonConstraint.mask` replicated warm-only: None when the
        state's summary has no cached base mask."""
        if state.summary() not in self._masks:
            self.misses += 1
            return None
        force = remaining <= self.budget_to_close(state) + 2
        return self.mask_for(state, force_close=force, remaining=remaining)

    def lookahead_groups(
        self, state: MachineState, allowed: np.ndarray, cap: int
    ) -> tuple[list[MachineState], np.ndarray] | None:
        """Group the candidate next tokens by exact successor state.

        ``allowed`` is the mask the in-flight step samples under. Returns
        ``(states, group_of)`` with ``group_of`` int32[vocab]: candidate
        tokens map to an index into ``states``, everything else (including
        EOS, whose sample the engine discards at harvest) maps to -1.
        Returns None — the caller barriers — when the answer would need a
        cold build or more than ``cap`` distinct successor states.
        """
        if not allowed.any():
            # Pathological (closer-less vocab fallback masks): the sampled
            # token is unconstrained, so no finite group table covers it.
            self.misses += 1
            return None
        cands = np.flatnonzero(allowed)
        if self.eos_ids:
            cands = cands[~np.isin(cands, np.asarray(self.eos_ids))]
        group_of = np.full(self.vocab_size, -1, np.int32)
        states: list[MachineState] = []
        if cands.size == 0:
            return states, group_of  # EOS-only: the row finishes at harvest
        if cands.size <= cap:
            # Few candidates: advance each piece directly (exact, cheap).
            pieces = self._ensure_pieces()
            index: dict[MachineState, int] = {}
            for t in cands.tolist():
                ns = advance_text(state, pieces[t])
                g = index.get(ns)
                if g is None:
                    if len(states) >= cap:
                        self.misses += 1
                        return None
                    g = index[ns] = len(states)
                    states.append(ns)
                group_of[t] = g
            self.hits += 1
            return states, group_of
        # Wide masks (e.g. IN_STRING admits most of the vocab): use the
        # transition table recorded when the summary's mask was built.
        table = self._descs.get(state.summary())
        if table is None:
            self.misses += 1
            return None
        desc_ids, descs = table
        ids = desc_ids[cands]
        if (ids < 0).any():
            # An allowed token outside the recorded table (force-close /
            # clamp edge): decline rather than guess.
            self.misses += 1
            return None
        uniq, inv = np.unique(ids, return_inverse=True)
        if uniq.size > cap:
            self.misses += 1
            return None
        for d in uniq.tolist():
            mode, literal, rel, pushed, num_ok, no_close = descs[d]
            states.append(MachineState(
                mode, literal, state.stack[: state.depth + rel] + pushed,
                num_ok, no_close,
            ))
        group_of[cands] = inv.astype(np.int32)
        self.hits += 1
        return states, group_of


@dataclasses.dataclass
class JsonConstraint:
    """Per-request constrained-decoding state (lives on the Sequence)."""

    cache: TokenMaskCache
    state: MachineState = dataclasses.field(default_factory=MachineState)

    def mask(self, remaining_tokens: int) -> np.ndarray:
        force = remaining_tokens <= self.cache.budget_to_close(self.state) + 2
        return self.cache.mask_for(
            self.state, force_close=force, remaining=remaining_tokens
        )

    def accept(self, token_id: int) -> None:
        piece = self.cache._ensure_pieces()[token_id] if token_id < self.cache.vocab_size else ""
        if token_id in self.cache.eos_ids:
            return
        self.state = advance_text(self.state, piece)
