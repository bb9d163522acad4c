"""From-scratch unigram-LM tokenizer training (sentencepiece-compatible;
`intrepppid_tpu/data/spm/trainer.py` counterpart, piece for piece).

Completes the tokenizer subsystem end-to-end: the reference's workflow
needs Google's external ``spm_train`` binary to build the ``.model`` its
datasets ship with (`intrepppid/data/ppi_oma.py:57` just loads one); this
trainer produces the same artifact from a raw corpus with zero external
tools — train → save (our protobuf writer) → load in the Python oracle or
the native C++ engine.

The algorithm follows sentencepiece's published unigram trainer
(Kudo 2018, "Subword Regularization", §3.2; unigram_model_trainer.cc):

1. **Seed** — frequent substrings up to ``max_piece_len``, mined with an
   Apriori-style frequency sieve (every substring of a frequent substring
   is at least as frequent, so length-k candidates extend only length-k-1
   survivors), scored ``freq * len``, top ``seed_size`` kept. All single
   characters are always included (full coverage — protein alphabets are
   tiny and every residue must be encodable).
2. **EM** — E-step: forward-backward over each sentence's segmentation
   lattice gives expected piece counts (exact, float64 log-space);
   M-step: ``score_i = digamma(c_i) − digamma(Σc)`` (sentencepiece's
   Bayesianized log-probability).
3. **Prune** — Viterbi-segment the corpus for piece usage counts; each
   piece's loss is ``usage · (logp(piece) − logp(best alternative
   segmentation))``; singles are always kept; the rest shrink by
   ``shrinking_factor`` per round until ≤ 1.1 × the target.
4. **Finalize** — top ``vocab_size − 3`` pieces by score (singles first),
   plus the ``<unk>/<s>/</s>`` meta pieces at ids 0/1/2.

Exact parity with Google's trainer is not a testable contract here (the
binary is not in this image and seeding/tie-breaks differ); the pinned
oracle is HuggingFace tokenizers' independent Rust ``UnigramTrainer`` —
same algorithm family — against which vocabulary overlap and segmentation
granularity are asserted, plus EM-monotonicity and round-trip contracts
(`tests/test_spm_trainer.py`).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


@dataclass
class TrainerConfig:
    vocab_size: int = 250
    max_piece_len: int = 16
    seed_size: int = 8000
    min_substring_freq: int = 2
    shrinking_factor: float = 0.75
    num_sub_iterations: int = 2
    max_rounds: int = 16


def _digamma(x):
    from scipy.special import digamma

    return digamma(x)


# --------------------------------------------------------------------- seed
def _seed_pieces(
    corpus: Sequence[Tuple[str, int]], cfg: TrainerConfig
) -> Dict[str, float]:
    """Candidate pieces -> raw weight (freq * len). Apriori sieve over
    lengths: length-k candidates only extend length-(k-1) survivors."""
    singles: Counter = Counter()
    for s, w in corpus:
        for ch in s:
            singles[ch] += w
    survivors = set(singles)
    weights: Dict[str, float] = {
        ch: float(c) for ch, c in singles.items()
    }
    prev = survivors
    for k in range(2, cfg.max_piece_len + 1):
        counts: Counter = Counter()
        for s, w in corpus:
            n = len(s)
            for i in range(n - k + 1):
                sub = s[i : i + k]
                # Apriori: both length-(k-1) halves must have survived
                if sub[:-1] in prev and sub[1:] in prev:
                    counts[sub] += w
        prev = {
            sub for sub, c in counts.items() if c >= cfg.min_substring_freq
        }
        if not prev:
            break
        for sub in prev:
            weights[sub] = float(counts[sub]) * len(sub)
    # keep all singles + top seed_size multi-char candidates
    multis = sorted(
        ((w, p) for p, w in weights.items() if len(p) > 1), reverse=True
    )[: cfg.seed_size]
    out = {p: float(singles[p]) for p in singles}
    out.update({p: w for w, p in multis})
    return out


# ------------------------------------------------------------------ lattice
def _build_edges(
    s: str, piece_ids: Dict[str, int], max_len: int
) -> List[List[Tuple[int, int]]]:
    """edges[i] = list of (j, piece_id) spanning s[i:j]."""
    n = len(s)
    edges: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for i in range(n):
        top = min(n, i + max_len)
        for j in range(i + 1, top + 1):
            pid = piece_ids.get(s[i:j])
            if pid is not None:
                edges[i].append((j, pid))
    return edges


def _forward_backward(
    s: str,
    edges: List[List[Tuple[int, int]]],
    scores: np.ndarray,
    weight: float,
    counts: np.ndarray,
) -> float:
    """Accumulate expected piece counts; returns weighted log Z. Sentences
    with unreachable positions (can't happen with singles in-vocab)
    contribute -inf."""
    n = len(s)
    NEG = -1e30
    alpha = np.full(n + 1, NEG)
    alpha[0] = 0.0
    for i in range(n):
        ai = alpha[i]
        if ai <= NEG / 2:
            continue
        for j, pid in edges[i]:
            v = ai + scores[pid]
            aj = alpha[j]
            alpha[j] = v if aj <= NEG / 2 else np.logaddexp(aj, v)
    logz = alpha[n]
    if logz <= NEG / 2:
        return float("-inf")
    beta = np.full(n + 1, NEG)
    beta[n] = 0.0
    for i in range(n - 1, -1, -1):
        acc = NEG
        for j, pid in edges[i]:
            bj = beta[j]
            if bj <= NEG / 2:
                continue
            v = scores[pid] + bj
            acc = v if acc <= NEG / 2 else np.logaddexp(acc, v)
            # edge posterior
            post = alpha[i] + v - logz
            if post > -40.0:
                counts[pid] += weight * math.exp(post)
        beta[i] = acc
    return weight * float(logz)


def _viterbi_best(
    s: str,
    edges: List[List[Tuple[int, int]]],
    scores: np.ndarray,
    skip_identity_pid: int = -1,
) -> Tuple[float, List[int]]:
    """Best segmentation (score, piece ids); optionally forbids the single
    edge spanning the whole string with id ``skip_identity_pid`` (used for
    a piece's best *alternative* segmentation)."""
    n = len(s)
    NEG = -1e30
    best = np.full(n + 1, NEG)
    back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        bi = best[i]
        if bi <= NEG / 2:
            continue
        for j, pid in edges[i]:
            if i == 0 and j == n and pid == skip_identity_pid:
                continue
            v = bi + scores[pid]
            if v > best[j]:
                best[j] = v
                back[j] = (i, pid)
    if best[n] <= NEG / 2:
        return float("-inf"), []
    ids = []
    j = n
    while j > 0:
        i, pid = back[j]
        ids.append(pid)
        j = i
    return float(best[n]), ids[::-1]


# -------------------------------------------------------------------- train
class UnigramTrainerResult:
    def __init__(self, pieces: List[Tuple[str, float]], objectives: List[float]):
        self.pieces = pieces  # (piece, log-prob score), finalized order
        self.objectives = objectives  # per-EM-iteration corpus log-likelihood


def train_unigram_pieces(
    sentences: Iterable[str], cfg: TrainerConfig
) -> UnigramTrainerResult:
    corpus_counter: Counter = Counter()
    for s in sentences:
        if s:
            corpus_counter[s] += 1
    if not corpus_counter:
        raise ValueError("empty corpus")
    corpus = list(corpus_counter.items())

    weights = _seed_pieces(corpus, cfg)
    singles = {p for p in weights if len(p) == 1}
    n_reserved = 3  # <unk>, <s>, </s>
    if cfg.vocab_size < len(singles) + n_reserved + 1:
        raise ValueError(
            f"vocab_size={cfg.vocab_size} too small: corpus has "
            f"{len(singles)} distinct characters + {n_reserved} meta pieces"
        )
    pieces = sorted(weights)
    total = sum(weights.values())
    scores = {p: math.log(weights[p] / total) for p in pieces}
    target = cfg.vocab_size - n_reserved

    objectives: List[float] = []
    for _round in range(cfg.max_rounds):
        piece_ids = {p: i for i, p in enumerate(pieces)}
        score_arr = np.array([scores[p] for p in pieces])
        edge_cache = [
            _build_edges(s, piece_ids, cfg.max_piece_len) for s, _ in corpus
        ]
        # ---- EM sub-iterations at fixed vocabulary
        for _sub in range(cfg.num_sub_iterations):
            counts = np.zeros(len(pieces))
            ll = 0.0
            for (s, w), edges in zip(corpus, edge_cache):
                ll += _forward_backward(s, edges, score_arr, w, counts)
            objectives.append(ll)
            # M-step: Bayesianized log-probs; unseen pieces floor hard
            tot = counts.sum()
            with np.errstate(all="ignore"):
                new = _digamma(np.maximum(counts, 1e-12)) - _digamma(tot)
            score_arr = np.where(counts > 1e-9, new, -1e4)
        scores = {p: float(score_arr[i]) for i, p in enumerate(pieces)}

        if len(pieces) <= int(target * 1.1):
            break

        # ---- prune by likelihood loss
        usage = np.zeros(len(pieces))
        for (s, w), edges in zip(corpus, edge_cache):
            _, ids = _viterbi_best(s, edges, score_arr)
            for pid in ids:
                usage[pid] += w
        losses: List[Tuple[float, str]] = []
        keep: List[str] = []
        for i, p in enumerate(pieces):
            if len(p) == 1:
                keep.append(p)
                continue
            if usage[i] == 0.0:
                losses.append((0.0, p))
                continue
            p_edges = _build_edges(p, piece_ids, cfg.max_piece_len)
            alt, _ = _viterbi_best(p, p_edges, score_arr, skip_identity_pid=i)
            if alt == float("-inf"):
                keep.append(p)  # not segmentable without itself
                continue
            losses.append((usage[i] * (score_arr[i] - alt), p))
        n_keep_multi = max(
            target - len(keep), int(len(losses) * cfg.shrinking_factor)
        )
        losses.sort(key=lambda t: (-t[0], t[1]))
        keep.extend(p for _, p in losses[:n_keep_multi])
        if len(keep) == len(pieces):
            break  # nothing prunable
        pieces = sorted(keep)
        scores = {p: scores[p] for p in pieces}

    # ---- finalize: singles always in; fill with top multis by score
    multis = sorted(
        (p for p in pieces if len(p) > 1), key=lambda p: -scores[p]
    )
    final = sorted(singles) + multis[: max(0, target - len(singles))]
    # renormalize to log-probabilities over the final vocabulary
    arr = np.array([scores[p] for p in final])
    arr -= float(np.logaddexp.reduce(arr))
    ordered = sorted(zip(final, arr.tolist()), key=lambda t: -t[1])
    return UnigramTrainerResult(ordered, objectives)


def train_unigram_model(sentences: Iterable[str], cfg: TrainerConfig):
    """Train and package as an :class:`SpmModel` (save with
    ``proto.save_model``; loads in both engines)."""
    from intrepppid_tpu_torch.data.spm.proto import (
        CONTROL,
        NORMAL,
        UNKNOWN,
        NormalizerSpec,
        SentencePieceEntry,
        SpmModel,
    )

    result = train_unigram_pieces(sentences, cfg)
    entries = [
        SentencePieceEntry("<unk>", 0.0, UNKNOWN),
        SentencePieceEntry("<s>", 0.0, CONTROL),
        SentencePieceEntry("</s>", 0.0, CONTROL),
    ]
    for piece, score in result.pieces:
        entries.append(SentencePieceEntry(piece, float(score), NORMAL))
    model = SpmModel(
        pieces=entries,
        unk_id=0,
        bos_id=1,
        eos_id=2,
        pad_id=-1,
        normalizer=NormalizerSpec(name="identity", add_dummy_prefix=False),
    )
    return model, result
