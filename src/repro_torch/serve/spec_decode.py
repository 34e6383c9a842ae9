"""Self-speculative drafting: n-gram prompt-lookup, no second model.

EdgeProfiler prices decode as strictly memory-bound — every step
re-reads the weights and the KV cache to emit ONE token — which is
exactly the regime speculative decoding attacks: verify K drafted
tokens in one multi-query paged decode window
(``models.lm.decode_window_paged``) and the weight/page traffic is
amortized over every accepted token.  On an edge box there is no
budget for a second draft model, so drafts come from the request's own
context (prompt-lookup / n-gram speculation): if the last ``n`` tokens
have occurred before, propose the tokens that followed that occurrence.
Templated prompts, code, retrieval-grounded answers, and the repetitive
tails greedy decoding settles into all hit this table constantly;
adversarial text simply misses and the scheduler falls back to the
plain K=1 decode step for that slot — drafting never changes outputs,
only how many verified tokens each iteration commits (greedy acceptance
in ``serve.backend._decode_window_fn`` keeps emissions token-for-token
the sequential greedy decode).

``NGramDraftTable`` is O(1) per appended token and per proposal: it
tracks, for the current context tail, the most recent PRIOR occurrence
of its last n-gram, which is all a proposal needs.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


class NGramDraftTable:
    """Per-request n-gram lookup table over prompt + generated tokens.

    ``extend`` appends committed tokens (prompt at admission, verified
    emissions each step); ``propose(k)`` returns up to ``k`` draft
    tokens — the continuation of the most recent earlier occurrence of
    the context's final n-gram, or ``[]`` on a miss (the caller then
    runs a plain one-token step).  A preempted request's recompute
    incarnation simply builds a fresh table from its new prompt (which
    already contains the prior output), so preemption needs no special
    casing.
    """

    def __init__(self, n: int = 2):
        if n < 1:
            raise ValueError(f"ngram size must be >= 1, got {n}")
        self.n = n
        self.tokens: List[int] = []
        # last end-position of each n-gram seen so far
        self._last: Dict[Tuple[int, ...], int] = {}
        # prior occurrence (end position) of the CURRENT tail n-gram
        self._prior_of_tail: Optional[int] = None

    def __len__(self) -> int:
        return len(self.tokens)

    def extend(self, toks: Iterable[int]) -> None:
        for t in toks:
            self.tokens.append(int(t))
            i = len(self.tokens) - 1            # end position of new gram
            if i + 1 < self.n:
                continue
            gram = tuple(self.tokens[i - self.n + 1:i + 1])
            self._prior_of_tail = self._last.get(gram)
            self._last[gram] = i

    def propose(self, k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing the latest prior
        occurrence of the context's final n-gram ([] on a miss).

        When the continuation runs off the end of the known context —
        the prior occurrence sits less than ``k`` tokens back, i.e. the
        stream is repeating with a short period — the proposal
        extrapolates PERIODICALLY by continuing from itself, so a
        period-2 greedy loop still fills a K=8 window instead of
        proposing two tokens and stalling at the period length.
        Mispredictions only cost wasted in-window verify compute; the
        committed tokens are always the verified greedy ones.
        """
        p = self._prior_of_tail
        if k <= 0 or p is None:
            return []
        out: List[int] = []
        L = len(self.tokens)
        for idx in range(p + 1, p + 1 + k):
            out.append(self.tokens[idx] if idx < L else out[idx - L])
        return out
