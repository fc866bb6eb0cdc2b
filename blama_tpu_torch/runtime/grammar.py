"""GBNF grammar engine for constrained decoding.

Host-side replacement for llama.cpp's grammar sampler, driven exactly the way
the reference drives it: a separate grammar sampler beside the chain with the
sample → check → resample strategy (reference llama/
Sampler.cpp:126-173), accept() fed only for generated tokens
(Session.cpp:375-377).

Implements the public GBNF dialect: named rules (`name ::= ...`),
alternation `|`, grouping `(...)`, literals `"..."` with escapes, char
classes `[a-z^...]`, repetition `* + ? {m,n}`, comments `#`, rule
references. Matching uses the pushdown-automaton scheme: a grammar state is
a set of expansion stacks over code points; accepting a code point advances
every stack that admits it. Token pieces are consumed as UTF-8 with partial
code-point carry across token boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass


# -- grammar element model ---------------------------------------------------

@dataclass(frozen=True)
class CharClass:
    """Set of codepoint ranges; negated matches the complement."""

    ranges: tuple[tuple[int, int], ...]
    negated: bool = False

    def matches(self, cp: int) -> bool:
        hit = any(lo <= cp <= hi for lo, hi in self.ranges)
        return (not hit) if self.negated else hit


@dataclass(frozen=True)
class RuleRef:
    name: str


Element = "CharClass | RuleRef"
Sequence = tuple  # tuple[Element, ...]
# A rule is a list of alternative sequences.


class GBNFParser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list[Sequence]] = {}
        self._gen = 0

    # -- lexing helpers ---

    def _ws(self, newlines: bool = True) -> None:
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.pos += 1
            elif c == "\n":
                # newline ends a rule unless followed by indent continuation
                j = self.pos + 1
                while j < len(self.text) and self.text[j] in " \t\r":
                    j += 1
                if j < len(self.text) and self.text[j] in "|)":
                    self.pos = j
                else:
                    return
            else:
                return

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        while self._peek() and (self._peek().isalnum() or self._peek() in "-_"):
            self.pos += 1
        if start == self.pos:
            raise ValueError(f"expected name at {self.pos} in grammar")
        return self.text[start: self.pos]

    def _escaped_char(self) -> int:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self.text[self.pos]
        self.pos += 1
        table = {"n": 10, "t": 9, "r": 13, '"': 34, "'": 39, "\\": 92, "[": 91, "]": 93, "^": 94, "-": 45, "/": 47}
        if e in table:
            return table[e]
        if e == "x":
            v = int(self.text[self.pos: self.pos + 2], 16)
            self.pos += 2
            return v
        if e == "u":
            v = int(self.text[self.pos: self.pos + 4], 16)
            self.pos += 4
            return v
        if e == "U":
            v = int(self.text[self.pos: self.pos + 8], 16)
            self.pos += 8
            return v
        raise ValueError(f"bad escape \\{e}")

    # -- parsing ---

    def parse(self) -> dict[str, list[Sequence]]:
        self._ws()
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws()
        if "root" not in self.rules:
            raise ValueError("grammar must define a 'root' rule")
        return self.rules

    def _parse_rule(self) -> None:
        name = self._name()
        self._ws()
        if self.text[self.pos: self.pos + 3] != "::=":
            raise ValueError(f"expected ::= after rule name {name!r}")
        self.pos += 3
        self._ws()
        alts = self._parse_alternates(name)
        self.rules[name] = alts

    def _parse_alternates(self, rule_name: str) -> list[Sequence]:
        alts = [self._parse_sequence(rule_name)]
        self._ws()
        while self._peek() == "|":
            self.pos += 1
            self._ws()
            alts.append(self._parse_sequence(rule_name))
            self._ws(newlines=False)
            # allow newline continuation before '|'
            save = self.pos
            self._ws()
            if self._peek() != "|":
                self.pos = save
                break
        return alts

    def _fresh_rule(self, rule_name: str, alts: list[Sequence]) -> RuleRef:
        self._gen += 1
        name = f"{rule_name}_{self._gen}"
        self.rules[name] = alts
        return RuleRef(name)

    def _parse_sequence(self, rule_name: str) -> Sequence:
        items: list = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == "" or c in "|)\n":
                break
            if c == '"':
                self.pos += 1
                while self._peek() != '"':
                    items.append(CharClass(((lambda v: (v, v))(self._escaped_char()),)))
                self.pos += 1
            elif c == "[":
                self.pos += 1
                negated = self._peek() == "^"
                if negated:
                    self.pos += 1
                ranges = []
                while self._peek() != "]":
                    lo = self._escaped_char()
                    if self._peek() == "-" and self.text[self.pos + 1] != "]":
                        self.pos += 1
                        hi = self._escaped_char()
                    else:
                        hi = lo
                    ranges.append((lo, hi))
                self.pos += 1
                items.append(CharClass(tuple(ranges), negated))
            elif c == "(":
                self.pos += 1
                self._ws()
                alts = self._parse_alternates(rule_name)
                self._ws()
                if self._peek() != ")":
                    raise ValueError("expected )")
                self.pos += 1
                items.append(self._fresh_rule(rule_name, alts))
            elif c.isalnum() or c in "-_":
                items.append(RuleRef(self._name()))
            elif c == ".":
                self.pos += 1
                items.append(CharClass(((0, 0x10FFFF),)))
            else:
                raise ValueError(f"unexpected char {c!r} at {self.pos}")

            # repetition suffix applies to the last item
            self._ws(newlines=False)
            suf = self._peek()
            if suf in "*+?{" and items:
                last = items.pop()
                if suf == "{":
                    self.pos += 1
                    start = self.pos
                    while self._peek() not in ",}":
                        self.pos += 1
                    m = int(self.text[start: self.pos] or 0)
                    n = None
                    if self._peek() == ",":
                        self.pos += 1
                        start = self.pos
                        while self._peek() != "}":
                            self.pos += 1
                        frag = self.text[start: self.pos]
                        n = int(frag) if frag else None
                    else:
                        n = m
                    self.pos += 1
                    items.extend(self._expand_repeat(rule_name, last, m, n))
                else:
                    self.pos += 1
                    if suf == "?":
                        items.append(self._fresh_rule(rule_name, [(last,), ()]))
                    elif suf == "*":
                        ref = self._fresh_rule(rule_name, [])
                        self.rules[ref.name] = [(last, ref), ()]
                        items.append(ref)
                    else:  # +
                        ref = self._fresh_rule(rule_name, [])
                        self.rules[ref.name] = [(last, ref), (last,)]
                        items.append(ref)
        return tuple(items)

    def _expand_repeat(self, rule_name: str, item, m: int, n: int | None):
        out = [item] * m
        if n is None:
            ref = self._fresh_rule(rule_name, [])
            self.rules[ref.name] = [(item, ref), ()]
            out.append(ref)
        else:
            for _ in range(n - m):
                out.append(self._fresh_rule(rule_name, [(item,), ()]))
        return out


# -- pushdown matching -------------------------------------------------------

class GrammarMatcher:
    """Set-of-stacks incremental matcher over code points."""

    def __init__(self, rules: dict[str, list[Sequence]], root: str = "root"):
        self.rules = rules
        self.root = root
        self.reset()

    def reset(self) -> None:
        self.stacks: set[tuple] = set()
        for alt in self.rules[self.root]:
            self._push_expand(tuple(reversed(alt)), self.stacks, set())
        self._partial = b""

    def _push_expand(self, stack: tuple, out: set, seen: set) -> None:
        """Expand the top of the stack until it is a terminal (or empty)."""
        if stack in seen:
            return
        seen.add(stack)
        if not stack:
            out.add(stack)
            return
        top = stack[-1]
        if isinstance(top, CharClass):
            out.add(stack)
            return
        # RuleRef → replace with each alternative
        rest = stack[:-1]
        for alt in self.rules[top.name]:
            self._push_expand(rest + tuple(reversed(alt)), out, seen)

    def accept_cp(self, cp: int) -> bool:
        new: set[tuple] = set()
        seen: set = set()
        for stack in self.stacks:
            if stack and stack[-1].matches(cp):
                self._push_expand(stack[:-1], new, seen)
        if not new:
            return False
        self.stacks = new
        return True

    def _trial(self, data: bytes) -> bool:
        """Would consuming `data` keep at least one stack alive? (no commit)"""
        saved_stacks, saved_partial = self.stacks, self._partial
        ok = self.consume_bytes(data)
        self.stacks, self._partial = saved_stacks, saved_partial
        return ok

    @staticmethod
    def _partial_cp_range(frag: bytes) -> tuple[int, int] | None:
        """Codepoint range reachable by completing a partial UTF-8 sequence."""
        b0 = frag[0]
        if b0 < 0x80:
            return None
        if b0 < 0xC0:
            return None  # bare continuation byte: invalid lead
        n = 2 if b0 < 0xE0 else (3 if b0 < 0xF0 else 4)
        bits = b0 & (0x1F if n == 2 else (0x0F if n == 3 else 0x07))
        val = bits
        for b in frag[1:]:
            if b & 0xC0 != 0x80:
                return None
            val = (val << 6) | (b & 0x3F)
        missing = n - len(frag)
        lo = val << (6 * missing)
        hi = ((val + 1) << (6 * missing)) - 1
        # overlong encodings are invalid: clamp to the minimum codepoint
        # actually encodable at this sequence length
        min_cp = {2: 0x80, 3: 0x800, 4: 0x10000}[n]
        lo = max(lo, min_cp)
        if hi < lo:
            return None
        return lo, hi

    def consume_bytes(self, data: bytes) -> bool:
        buf = self._partial + data
        i = 0
        while i < len(buf):
            b0 = buf[i]
            n = 1 if b0 < 0x80 else (2 if b0 < 0xE0 else (3 if b0 < 0xF0 else 4))
            if i + n > len(buf):
                frag = buf[i:]
                rng = self._partial_cp_range(frag)
                if rng is None:
                    return False
                # viable only if some stack's terminal admits a codepoint in
                # the completable range
                lo, hi = rng
                if not any(
                    s and self._class_intersects(s[-1], lo, hi) for s in self.stacks
                ):
                    return False
                self._partial = frag
                return True
            try:
                cp = buf[i: i + n].decode("utf-8")
            except UnicodeDecodeError:
                return False
            if not self.accept_cp(ord(cp)):
                return False
            i += n
        self._partial = b""
        return bool(self.stacks)

    @staticmethod
    def _class_intersects(cc: CharClass, lo: int, hi: int) -> bool:
        inside = any(not (hi < rlo or lo > rhi) for rlo, rhi in cc.ranges)
        if not cc.negated:
            return inside
        # negated: intersects unless [lo,hi] is fully covered by the ranges —
        # a conservative approximation (full coverage check on merged ranges)
        covered = 0
        for rlo, rhi in sorted(cc.ranges):
            a, b = max(rlo, lo), min(rhi, hi)
            if a <= b:
                covered += b - a + 1
        return covered < (hi - lo + 1)

    @property
    def can_end(self) -> bool:
        return any(not s for s in self.stacks) and not self._partial


class GrammarSampler:
    """Sampler-side facade matching the llama.cpp grammar sampler contract the
    reference relies on (Sampler.cpp:16,101-107,126-173)."""

    # cap on distinct matcher states with memoized token masks; generation
    # states recur constantly (e.g. "inside a JSON string"), so this turns
    # the O(V·stacks) per-step mask of lazy grammars into a dict lookup
    _CACHE_MAX_STATES = 1024

    def __init__(self, grammar_text: str, vocab):
        self.vocab = vocab
        self._empty = not grammar_text.strip()
        self._allowed_cache: dict = {}
        if self._empty:
            self.matcher = None
            return
        rules = GBNFParser(grammar_text).parse()
        self.matcher = GrammarMatcher(rules)

    def reset(self) -> None:
        if self.matcher is not None:
            self.matcher.reset()

    def _state_key(self):
        # stacks are tuples of CharClass/RuleRef objects shared from the
        # parsed rules (matching never creates new terminals), so identity
        # hashing is stable
        return (frozenset(self.matcher.stacks), self.matcher._partial)

    def token_allowed(self, token: int) -> bool:
        if self.matcher is None:
            return True
        if len(self._allowed_cache) > self._CACHE_MAX_STATES:
            self._allowed_cache.clear()
        cache = self._allowed_cache.setdefault(self._state_key(), {})
        hit = cache.get(token)
        if hit is None:
            hit = self._compute_allowed(token)
            cache[token] = hit
        return hit

    def _compute_allowed(self, token: int) -> bool:
        if self.vocab.is_eog(token):
            return self.matcher.can_end
        piece = self.vocab.token_piece(token, special=False)
        if not piece:
            return False
        return self.matcher._trial(piece)

    def accept(self, token: int) -> None:
        if self.matcher is None or self.vocab.is_eog(token):
            return
        piece = self.vocab.token_piece(token, special=False)
        if piece:
            self.matcher.consume_bytes(piece)

    def apply(self, cand) -> None:
        """Mask candidates that violate the grammar (-inf), llama.cpp-style."""
        if self.matcher is None:
            return
        import numpy as np

        mask = np.fromiter(
            (self.token_allowed(int(t)) for t in cand.ids), bool, cand.ids.shape[0]
        )
        cand.logits[~mask] = -np.inf
