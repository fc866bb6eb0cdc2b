"""Streaming stop-string detection across token-piece boundaries.

Mirror of the reference AntipromptManager / IncrementalStringFinder
(reference llama/{AntipromptManager,
IncrementalStringFinder}.cpp), including the finder's naive single-character
restart on mismatch (IncrementalStringFinder.cpp:20-32 — deliberately not
KMP, to match behavior on overlapping prefixes) and the manager's
earliest-lexicographic match selection with trailing text included
(AntipromptManager.cpp:13-32).
"""

from __future__ import annotations


class IncrementalStringFinder:
    def __init__(self, search_str: str):
        self._search = search_str
        self._pos = 0

    def get_string(self) -> str:
        return self._search

    def get_current_pos(self) -> int:
        return self._pos

    def feed_text(self, text: str) -> int:
        """Return the index just past the match end in `text` when the search
        string completes during this feed; -1 otherwise. Match state carries
        across feeds."""
        if not self._search:
            return -1
        prompt_pos = 0
        while prompt_pos < len(text) and self._pos < len(self._search):
            if self._search[self._pos] != text[prompt_pos]:
                self._pos = 0
            if self._search[self._pos] == text[prompt_pos]:
                self._pos += 1
            prompt_pos += 1
        if self._pos == len(self._search):
            self._pos = 0
            return prompt_pos
        return -1

    def reset(self) -> None:
        self._pos = 0


class AntipromptManager:
    def __init__(self):
        self._antiprompts: list[IncrementalStringFinder] = []

    def add_antiprompt(self, antiprompt: str) -> None:
        self._antiprompts.append(IncrementalStringFinder(antiprompt))

    def feed_generated_text(self, text: str) -> str:
        """Feed a generated piece to every antiprompt; on a match, return the
        matched antiprompt plus the trailing text after the match point
        (empty string = no match)."""
        matched: list[tuple[str, int]] = []
        for ap in self._antiprompts:
            found = ap.feed_text(text)
            if found > 0:
                res = ap.get_string() + text[found:]
                matched.append((res, found))
        if matched:
            self.reset()
            matched.sort()
            return matched[0][0]
        return ""

    def reset(self) -> None:
        for ap in self._antiprompts:
            ap.reset()

    def clear(self) -> None:
        self._antiprompts.clear()

    def has_running_antiprompts(self) -> bool:
        return any(ap.get_current_pos() > 0 for ap in self._antiprompts)
