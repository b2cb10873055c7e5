"""Training data (port of ``kubetpu/jobs/data.py``): the deterministic
synthetic LM corpus, document packing and evaluation.

This is numpy code, copied so that the port imports nothing of
``kubetpu``; for the same seeds it yields byte-equal batches. Batches stay
host-side numpy; ``train.make_train_step``'s step uploads them.
``prefetch_to_mesh`` waits for the multi-device slice.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]  # (tokens, targets), both (B, S) int32


class SyntheticCorpus:
    """Deterministic pseudo-text: a Markov-ish integer stream with enough
    structure for a model to measurably learn (each next token depends on
    the previous one), reproducible from (vocab, seed)."""

    def __init__(self, vocab: int, seed: int = 0,
                 skew: Optional[Sequence[float]] = None):
        """``skew``: probability over the 4 successors (default uniform).
        A skewed chain (e.g. ``[0.85, 0.05, 0.05, 0.05]``) has a clearly
        learnable argmax — natural text is like this, and it is what makes
        a distilled draft's greedy agreement (speculative decoding's
        acceptance rate) meaningfully measurable on synthetic data."""
        self.vocab = vocab
        rng = np.random.RandomState(seed)
        # sparse row-stochastic transition structure: each token prefers a
        # handful of successors
        self._next = rng.randint(0, vocab, size=(vocab, 4))
        self._skew = None if skew is None else np.asarray(skew, np.float64)
        if self._skew is not None and (
            self._skew.shape != (4,) or abs(self._skew.sum() - 1.0) > 1e-9
        ):
            raise ValueError("skew must be 4 probabilities summing to 1")

    def batches(self, batch: int, seq: int, seed: int = 0) -> Iterator[Batch]:
        rng = np.random.RandomState(seed)
        while True:
            tokens = np.empty((batch, seq + 1), np.int32)
            tokens[:, 0] = rng.randint(0, self.vocab, size=batch)
            for t in range(seq):
                if self._skew is None:
                    choice = rng.randint(0, 4, size=batch)
                else:
                    choice = rng.choice(4, size=batch, p=self._skew)
                tokens[:, t + 1] = self._next[tokens[:, t], choice]
            yield tokens[:, :-1].copy(), tokens[:, 1:].copy()


def pack_documents(
    docs: Iterable,
    batch: int,
    seq: int,
    eos_id: int,
    mode: str = "stream",
    pad_id: int = 0,
    isolate_documents: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Pack variable-length token documents into fixed (B, S) training
    batches — yields (tokens, targets, weights), all (B, S), weights f32.

    Real corpora are mostly SHORT documents; without packing, a seq-4096
    batch of 300-token documents wastes >90% of every MXU matmul on pad.
    Two modes, both streaming (documents are consumed lazily):

    - ``"stream"`` (GPT-style): documents are concatenated with one
      ``eos_id`` after each and the stream is chopped into (seq+1) windows
      — zero pad (weights all 1), documents may straddle window
      boundaries. Maximum efficiency; the model sees cross-document
      attention, which the EOS token delimits (the standard pretraining
      trade).
    - ``"greedy"`` (first-fit): documents never split across rows; each
      row takes documents while they fit, the tail is padded with
      ``pad_id`` and weights 0 (train with
      ``make_train_step(weighted=True)``). Documents longer than seq+1
      are split anyway (they cannot fit whole by definition).

    Isolation caveat (both packing modes): a row holding several documents
    gives the model CROSS-DOCUMENT attention (no block-diagonal mask — the
    EOS delimiter is the only separation signal, the standard pretraining
    trade), and by default the EOS -> next-document-first-token transition
    trains at weight 1. ``isolate_documents=True`` zeros the weight on
    those cross-document transitions in greedy mode, so no position's loss
    asks the model to predict an unrelated document's opening token;
    attention still crosses documents within the row.

    ``weights.mean()`` IS the packing efficiency — worth logging.
    """
    if mode not in ("stream", "greedy"):
        raise ValueError(f"mode must be 'stream' or 'greedy', got {mode!r}")
    if isolate_documents and mode != "greedy":
        # stream mode chops a continuous token stream — document boundaries
        # deliberately vanish into it, so "isolation" cannot be honored;
        # refusing beats silently ignoring the caller's request
        raise ValueError("isolate_documents requires mode='greedy'")
    window = seq + 1

    def flush(rows, bounds=None):
        tokens = np.full((batch, seq), pad_id, np.int32)
        targets = np.full((batch, seq), pad_id, np.int32)
        weights = np.zeros((batch, seq), np.float32)
        for i, row in enumerate(rows):
            m = len(row)
            if m < 2:
                continue
            arr = np.asarray(row, np.int32)
            tokens[i, : m - 1] = arr[:-1]
            targets[i, : m - 1] = arr[1:]
            weights[i, : m - 1] = 1.0
            if bounds is not None:
                # zero the cross-document transitions: position cum-1
                # trains "last token of piece k -> first token of piece
                # k+1", an unlearnable target (isolate_documents)
                cum = 0
                for plen in bounds[i][:-1]:
                    cum += plen
                    if cum - 1 < seq:
                        weights[i, cum - 1] = 0.0
        return tokens, targets, weights

    if mode == "stream":
        buf: list = []
        rows: list = []
        for doc in docs:
            buf.extend(int(t) for t in doc)
            buf.append(eos_id)
            while len(buf) >= window:
                rows.append(buf[:window])
                # stride window-1: consecutive windows share one token, so
                # every stream position is a TARGET exactly once (stride
                # window would leave each boundary token never predicted —
                # the same off-by-one the greedy oversized split guards)
                buf = buf[window - 1:]
                if len(rows) == batch:
                    yield flush(rows)
                    rows = []
        return  # tail (partial window / partial batch) is dropped

    rows = [[] for _ in range(batch)]
    bounds = [[] for _ in range(batch)]  # per-row piece lengths
    iso = bounds if isolate_documents else None
    for doc in docs:
        pieces = [list(map(int, doc)) + [eos_id]]
        if len(pieces[0]) > window:  # cannot fit whole anywhere
            flat = pieces[0]
            # stride window-1: consecutive pieces overlap by one token, so
            # every boundary token still appears as an INPUT in the next
            # piece (a stride of window would silently drop its input role
            # — each row only trains on its first m-1 positions)
            pieces = [
                flat[i: i + window]
                for i in range(0, len(flat) - 1, window - 1)
            ]
        for piece in pieces:
            placed = False
            for row, b in zip(rows, bounds):
                if len(row) + len(piece) <= window:
                    row.extend(piece)
                    b.append(len(piece))
                    placed = True
                    break
            if not placed:
                yield flush(rows, iso)
                rows = [[] for _ in range(batch)]
                bounds = [[] for _ in range(batch)]
                iso = bounds if isolate_documents else None
                rows[0].extend(piece)
                bounds[0].append(len(piece))
    if any(rows):
        yield flush(rows, iso)


def evaluate(eval_step, params, batches: Iterable[Batch], n_batches: int):
    """Mean validation loss + perplexity over *n_batches* from *batches*.

    *eval_step* is ``train.make_eval_step``'s (params, tokens, targets) ->
    scalar loss; batches are numpy (tokens, targets) pairs, uploaded by the
    eval step. Losses stay on the device until one final fetch."""
    losses = []
    n_tokens = 0
    for tokens, targets in itertools.islice(iter(batches), n_batches):
        losses.append(eval_step(params, tokens, targets))
        n_tokens += int(np.prod(tokens.shape))  # shape only: no device fetch
    if not losses:
        raise ValueError("evaluate: no batches")
    mean = float(np.mean([float(l) for l in losses]))
    return {
        "loss": mean,
        "perplexity": float(np.exp(min(mean, 80.0))),
        "n_batches": len(losses),
        "n_tokens": n_tokens,
    }
