"""CTC decoding: greedy argmax on the device, prefix beam search on the host.

Port of ``ocrs_tpu.ops.ctc``. Label 0 is the CTC blank; label ``i`` maps to
``alphabet[i - 1]``. Decoded steps carry the input frame where each character
was first emitted. The device reduces the log-probs to the per-frame argmax
(greedy) or top-k candidates (beam), so that only those cross to the host;
the collapse and the prefix beam then run in C++ (:mod:`ocrs_tpu_torch.native`)
when that library is available, else in numpy and Python, with the same
results. The ``*_arrays`` forms return ``(pos, label)`` int32 array pairs
instead of :class:`CtcStep` objects, for the page pipeline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import native


@dataclass(frozen=True)
class CtcStep:
    """One decoded character: CTC label (>=1) and input frame index."""

    pos: int
    label: int


def greedy_labels(logprobs: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax over classes: [N, T, C] -> [N, T] int32."""
    return torch.argmax(logprobs, dim=-1).to(torch.int32)


def greedy_labels_u8(logprobs: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax over classes as uint8: [N, T, C] -> [N, T]. Ties go
    to the first maximal index, as ``jnp.argmax`` breaks them."""
    return torch.argmax(logprobs, dim=-1).to(torch.uint8)


def text_confidence(logprobs: torch.Tensor) -> torch.Tensor:
    """Per-line decode confidence over the NON-BLANK frames: [N, T, C] ->
    [N] float32 in (0, 1], exp(mean over frames whose argmax is a character
    of that character's log-probability).

    A graphics-only crop decodes as mostly-confident blanks plus a few
    low-probability character frames, so its all-frame mean looks fine while
    its character frames are garbage. Lines with no character frames return
    1.0: they emit no text, so they are never worth filtering."""
    maxlp, arg = torch.max(logprobs, dim=-1)  # [N, T]
    nonblank = arg != 0
    s = torch.where(nonblank, maxlp, 0.0).sum(dim=1)
    c = nonblank.sum(dim=1)
    return torch.exp(s / c.clamp_min(1)).to(torch.float32)


def mask_excluded(logprobs: torch.Tensor, excluded_onehot: torch.Tensor) -> torch.Tensor:
    """Set log-probability of excluded class labels to -inf
    (recognition.rs:547-561). `excluded_onehot` is [C] bool."""
    return logprobs.masked_fill(excluded_onehot, float("-inf"))


def collapse_greedy(labels: np.ndarray) -> list[CtcStep]:
    """Collapse repeats then drop blanks (standard CTC best-path). `labels`
    is a [T] int array of per-frame argmax labels; a step's position is the
    first frame of its run."""
    return collapse_greedy_batch(np.asarray(labels)[None])[0]


def _steps(pos: np.ndarray, lab: np.ndarray) -> list[CtcStep]:
    return [CtcStep(pos=int(p), label=int(l)) for p, l in zip(pos, lab)]


def _native_arrays(nat) -> list[tuple[np.ndarray, np.ndarray]]:
    pos, lab, counts = nat
    return [(pos[i, : counts[i]], lab[i, : counts[i]]) for i in range(len(counts))]


def collapse_greedy_batch_arrays(labels: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """:func:`collapse_greedy` over a [N, T] batch -> ``(pos, label)`` int32
    array pairs per line. The page pipeline uses this form: building tens of
    thousands of step objects per page group costs more host time than the
    collapse itself."""
    labels = np.asarray(labels)
    nat = native.ctc_collapse_batch(labels)
    if nat is not None:
        return _native_arrays(nat)
    labels = labels.astype(np.int32)
    prev = np.concatenate([np.zeros((labels.shape[0], 1), np.int32), labels[:, :-1]], axis=1)
    emit = (labels != 0) & (labels != prev)
    out = []
    for row, keep in zip(labels, emit):
        pos = np.flatnonzero(keep).astype(np.int32)
        out.append((pos, row[pos]))
    return out


def collapse_greedy_batch(labels: np.ndarray) -> list[list[CtcStep]]:
    """:func:`collapse_greedy` over a [N, T] batch."""
    return [_steps(pos, lab) for pos, lab in collapse_greedy_batch_arrays(labels)]


#: Per-frame candidate-class cap for the device->host beam read-back. A wide
#: beam does not need `width` candidate classes per frame: an extension by a
#: class ranked below ~8 is pruned at once for any peaked emission
#: distribution. The cap is part of the decode contract of the read-back path;
#: :func:`beam_decode_batch` on the full matrix stays uncapped.
BEAM_CANDIDATE_CAP = 8

#: Emission-gap prune on the device: candidates more than this many nats below
#: the frame's maximum are masked to -inf before the read-back.
BEAM_EMISSION_GAP = 10.0


def beam_candidate_k(width: int, n_classes: int) -> int:
    """Candidate classes per frame for a beam of ``width`` over
    ``n_classes``: ``min(max(width, 8), BEAM_CANDIDATE_CAP, n_classes)``."""
    return min(max(width, 8), BEAM_CANDIDATE_CAP, n_classes)


def _topk_stable(logprobs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest classes of every frame, values descending, equal values
    in order of class id, as ``jax.lax.top_k`` orders them (``torch.topk``
    leaves the order of ties open, and bf16 logits do tie)."""
    vals, idx = torch.sort(logprobs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_topk(logprobs: torch.Tensor, k: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame top-k candidates on the device: (vals, idx u8), [N, T, k]
    each, values descending."""
    vals, idx = _topk_stable(logprobs, k)
    return vals, idx.to(torch.uint8)


def beam_topk_packed(logprobs: torch.Tensor, k: int = 8, gap: float | None = None) -> torch.Tensor:
    """:func:`beam_topk` packed into ONE u8 buffer [N, T, 5k]: the float32
    candidate values as little-endian bytes, then the u8 class ids, so one
    copy to the host carries both. Unpack with :func:`unpack_topk`.

    ``gap``: candidate values below ``frame_max - gap`` become -inf. Top-k
    order puts masked entries at the tail, so the candidate list stays a
    descending prefix."""
    vals, idx = _topk_stable(logprobs, k)
    if gap is not None:
        vals = torch.where(vals < vals[..., :1] - gap, float("-inf"), vals)
    vb = vals.to(torch.float32).contiguous().view(torch.uint8)  # [N, T, 4k]
    return torch.cat([vb, idx.to(torch.uint8)], dim=-1)


def unpack_topk(buf: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`beam_topk_packed`: [N, T, 5k] u8 ->
    (vals f32 [N, T, k], idx i32 [N, T, k])."""
    buf = np.ascontiguousarray(buf)
    vals = np.ascontiguousarray(buf[..., : 4 * k]).view(np.float32).reshape(*buf.shape[:-1], k)
    idx = buf[..., 4 * k :].astype(np.int32)
    return vals, idx


def _topk_to_full(vals: np.ndarray, idx: np.ndarray, n_classes: int) -> np.ndarray:
    """Scatter [T, K] candidates back to a [T, C] -inf-filled matrix: the
    beam on this sparse matrix equals the beam on the full one, because both
    prune to the same candidate set."""
    full = np.full((vals.shape[0], n_classes), -np.inf, dtype=np.float32)
    np.put_along_axis(full, idx.astype(np.int64), vals, axis=-1)
    return full


def _beam_arrays(steps: list[CtcStep]) -> tuple[np.ndarray, np.ndarray]:
    return (
        np.array([s.pos for s in steps], dtype=np.int32),
        np.array([s.label for s in steps], dtype=np.int32),
    )


def beam_decode_topk_arrays(
    vals: np.ndarray, idx: np.ndarray, beam_width: int, n_classes: int
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Batched beam decode from device top-k read-backs ([N, T, K] each) ->
    ``(pos, label)`` int32 array pairs per line."""
    vals = np.asarray(vals, dtype=np.float32)
    idx = np.asarray(idx, dtype=np.int32)
    nat = native.ctc_beam_topk(vals, idx, beam_width)
    if nat is not None:
        return _native_arrays(nat)
    return [
        _beam_arrays(beam_decode(_topk_to_full(vals[i], idx[i], n_classes), beam_width))
        for i in range(vals.shape[0])
    ]


def beam_decode_topk(
    vals: np.ndarray, idx: np.ndarray, beam_width: int, n_classes: int
) -> list[list[CtcStep]]:
    """:func:`beam_decode_topk_arrays` as :class:`CtcStep` lists."""
    return [_steps(pos, lab) for pos, lab in beam_decode_topk_arrays(vals, idx, beam_width, n_classes)]


def beam_decode_batch_arrays(
    logprobs: np.ndarray, beam_width: int, excluded: Optional[Sequence[int]] = None
) -> list[tuple[np.ndarray, np.ndarray]]:
    """CTC prefix beam search over [N, T, C] log-probabilities ->
    ``(pos, label)`` int32 array pairs per line: the C++ beam over the
    per-frame top ``max(width, 8)`` candidates (the pruning of
    :func:`beam_decode`), or :func:`beam_decode` line by line."""
    lp = np.asarray(logprobs)
    onehot = None
    if excluded:
        onehot = np.zeros((lp.shape[-1],), dtype=np.uint8)
        onehot[list(excluded)] = 1
    nat = native.ctc_beam_batch(lp, beam_width, onehot)
    if nat is not None:
        return _native_arrays(nat)
    return [_beam_arrays(beam_decode(lp[i], beam_width, excluded)) for i in range(lp.shape[0])]


def beam_decode_batch(
    logprobs: np.ndarray, beam_width: int, excluded: Optional[Sequence[int]] = None
) -> list[list[CtcStep]]:
    """:func:`beam_decode_batch_arrays` as :class:`CtcStep` lists."""
    return [_steps(pos, lab) for pos, lab in beam_decode_batch_arrays(logprobs, beam_width, excluded)]


def beam_decode(
    logprobs: np.ndarray, beam_width: int, excluded: Optional[Sequence[int]] = None
) -> list[CtcStep]:
    """CTC prefix beam search over a [T, C] log-probability matrix.

    Standard prefix-merging beam search (no language model), equivalent in
    role to upstream's ``CtcDecoder::decode_beam`` (recognition.rs:517-520).
    Returns the steps of the most probable label sequence; each step's
    ``pos`` is the frame at which that character was first appended on the
    best path."""
    lp = np.array(logprobs, dtype=np.float64)
    t_len, _ = lp.shape
    if excluded:
        lp[:, list(excluded)] = -np.inf

    NEG_INF = -np.inf

    def logaddexp(a: float, b: float) -> float:
        if a == NEG_INF:
            return b
        if b == NEG_INF:
            return a
        m = max(a, b)
        return m + math.log(math.exp(a - m) + math.exp(b - m))

    # beams: prefix (tuple of (pos, label)) -> [p_blank, p_nonblank]
    beams: dict[tuple, list[float]] = {(): [0.0, NEG_INF]}

    for t in range(t_len):
        frame = lp[t]
        # Only the top candidate classes of this frame are considered.
        order = np.argsort(frame)[::-1]
        order = [c for c in order[: max(beam_width, 8)] if frame[c] > NEG_INF]
        next_beams: dict[tuple, list[float]] = {}

        def acc(prefix: tuple, which: int, value: float) -> None:
            entry = next_beams.setdefault(prefix, [NEG_INF, NEG_INF])
            entry[which] = logaddexp(entry[which], value)

        for prefix, (p_b, p_nb) in beams.items():
            total = logaddexp(p_b, p_nb)
            last_label = prefix[-1][1] if prefix else None
            for c in order:
                p = float(frame[c])
                if c == 0:
                    acc(prefix, 0, total + p)
                elif c == last_label:
                    # Repeat without blank extends the same char...
                    acc(prefix, 1, p_nb + p)
                    # ...or, after a blank, starts a new one.
                    acc(prefix + ((t, c),), 1, p_b + p)
                else:
                    acc(prefix + ((t, c),), 1, total + p)

        pruned = sorted(
            next_beams.items(),
            key=lambda kv: logaddexp(kv[1][0], kv[1][1]),
            reverse=True,
        )[:beam_width]
        beams = dict(pruned)

    best_prefix = max(beams.items(), key=lambda kv: logaddexp(kv[1][0], kv[1][1]))[0]
    return [CtcStep(pos=int(p), label=int(l)) for p, l in best_prefix]
