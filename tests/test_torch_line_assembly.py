"""Line assembly: decoded CTC steps become ``TextLine``s of ``TextChar``s
with rects (``recognition._text_lines_from_results``), in one pass over every
axis-aligned line handed over, against the JAX package's line-by-line
``_text_lines_from_results`` on the same numpy inputs made from a seed, on
the CPU. Every char and all four edges of its rect must be equal bit for
bit; the page pipeline's assembly of a whole group must give each page what
assembling that page alone gives; and the JSON and text output of the lines
must be byte for byte the JAX package's.

Run as a script, it times both assemblies on a group shaped like the
benchmark's page group (337 lines, ~8,200 chars), the port taken from the
checkout that ``PYTHONPATH`` names (another commit's checkout times that
commit's port against the same JAX function):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_line_assembly.py
"""

import statistics
import time

import numpy as np
import pytest
import torch

from ocrs_tpu import output as jout
from ocrs_tpu import recognition as jrecog
from ocrs_tpu.geometry import Rect as JaxRect
from ocrs_tpu.geometry import RotatedRect as JaxRotatedRect
from ocrs_tpu.ops.ctc import CtcStep as JaxCtcStep
import ocrs_tpu_torch as ot
from ocrs_tpu_torch import output as tout
from ocrs_tpu_torch import recognition as trecog
from ocrs_tpu_torch.geometry import Rect, RotatedRect
from ocrs_tpu_torch.models.fakes import FakeDetectionModel, FakeRecognitionModel
from ocrs_tpu_torch.ops.ctc import CtcStep, collapse_greedy_batch_arrays

ALPHABET = "abcdefghijklmnopqrstuvwxyz "
REC_HEIGHT = 64


def _line_spec(rng, i, o):
    """One line's inputs as plain numbers: word rects, input lengths, steps."""
    ks = o.get("words")
    k = ks[i % len(ks)] if ks else int(rng.integers(1, 7))
    x = float(rng.uniform(-80.0, -5.0)) if o.get("negative_lefts") and i % 2 == 0 else float(rng.uniform(5.0, 400.0))
    y0 = 40.0 * i + float(rng.uniform(0.0, 5.0))
    words = []
    for _ in range(k):
        w, h = float(rng.uniform(8.0, 60.0)), float(rng.uniform(10.0, 24.0))
        cy = y0 + h / 2 + float(rng.uniform(-2.0, 2.0))
        th = float(rng.uniform(-0.12, 0.12)) if rng.random() < 0.3 else 0.0
        words.append(((x + w / 2, cy), (np.sin(th), -np.cos(th)), w, h))
        x += w + float(rng.uniform(2.0, 15.0))
    poly = trecog.line_polygon([RotatedRect(*w) for w in words])
    (left, top), (right, bottom) = poly.min(0).astype(np.float64), poly.max(0).astype(np.float64)
    resized = trecog.resized_line_width(right - left, bottom - top, REC_HEIGHT)
    rec_len = (resized // 128 + 2) * 128
    ds = int(rng.choice([4, 8])) if o.get("mixed_lengths") else 4
    ctc_len = rec_len // ds - (int(rng.integers(0, 2)) if o.get("mixed_lengths") else 0)
    inside = -(-resized // round(rec_len / ctc_len))  # frames whose char starts before the rect's right
    kind = "steps"
    if o.get("empty") and i % 5 == 1:
        kind = "no_steps"
    elif o.get("empty") and i % 5 == 3:
        kind = "all_out"
    if kind == "no_steps":
        pos = np.zeros(0, np.int64)
    elif kind == "all_out":
        pos = np.sort(rng.choice(np.arange(inside + 1, ctc_len), size=3, replace=False))
    else:
        hi = ctc_len if o.get("padding") else inside
        pos = np.sort(rng.choice(hi, size=int(rng.integers(1, max(2, min(hi, 40)))), replace=False))
    lo, hi = (0, len(ALPHABET) + 4) if o.get("labels_outside") else (1, len(ALPHABET) + 1)
    labels = rng.integers(lo, hi, len(pos))
    return {
        "words": words, "poly": poly, "box": (top, left, bottom, right), "resized": resized, "rec_len": rec_len,
        "ctc_len": ctc_len, "pos": pos.astype(np.int32), "labels": labels.astype(np.int32),
        "objects": o.get("step_forms") and i % 2 == 1, "rotated": i in o.get("rotated", ()),
    }


def _results(specs, rect_cls, rrect_cls, recog, step_cls):
    """One package's ``_LineResult``s for the line specs."""
    out = []
    for i, s in enumerate(specs):
        rrect = recog.line_rotated_rect([rrect_cls(*w) for w in s["words"]]) if s["rotated"] else None
        line = recog._RecLine(index=i, poly=s["poly"], rect=rect_cls.from_tlbr(*s["box"]),
                              resized_width=s["resized"], rrect=rrect)
        steps = (s["pos"], s["labels"])
        if s["objects"]:
            steps = [step_cls(int(p), int(l)) for p, l in zip(*steps)]
        out.append(recog._LineResult(line, s["rec_len"], s["ctc_len"], steps))
    return out


def _group(n, seed, **opts):
    rng = np.random.default_rng(seed)
    specs = [_line_spec(rng, i, opts) for i in range(n)]
    return (
        specs,
        _results(specs, Rect, RotatedRect, trecog, CtcStep),
        _results(specs, JaxRect, JaxRotatedRect, jrecog, JaxCtcStep),
    )


def _bits(line):
    """Chars and the float64 bits of their rects' edges."""
    if line is None:
        return None
    return [(c.char, np.array([c.rect.top, c.rect.left, c.rect.bottom, c.rect.right], np.float64).tobytes())
            for c in line.chars()]


CASES = {
    "one_line": dict(n=1),
    "seven_lines": dict(n=7),
    "sixty_lines": dict(n=60, words=(1, 32, 3, 9, 2, 17, 4), negative_lefts=True, padding=True, empty=True,
                        labels_outside=True, step_forms=True, rotated=(9, 32), mixed_lengths=True),
    "vertex_counts_4_to_128": dict(n=12, words=(1, 32, 2, 16, 5, 31, 1, 8, 3, 24, 32, 4)),
    "negative_lefts": dict(n=7, negative_lefts=True),
    "steps_in_padding": dict(n=7, padding=True),
    "no_steps_and_all_out_of_bounds": dict(n=7, empty=True),
    "labels_0_and_past_the_alphabet": dict(n=7, labels_outside=True),
    "both_step_forms": dict(n=7, step_forms=True),
    "rotated_between_axis_aligned": dict(n=5, rotated=(2,)),
    "mixed_input_lengths": dict(n=7, mixed_lengths=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_group_assembly_equals_jax_line_by_line(case):
    opts = dict(CASES[case])
    n = opts.pop("n")
    specs, port, jax = _group(n, seed=sorted(CASES).index(case), **opts)
    got = trecog._text_lines_from_results(port, ALPHABET)
    want = jrecog._text_lines_from_results(jax, ALPHABET)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)
    # Each line alone is the same line.
    for r, g in zip(port, got):
        assert _bits(trecog._text_lines_from_results([r], ALPHABET)[0]) == _bits(g)
    # The case holds what it names.
    chars = [c for line in got if line is not None for c in line.chars()]
    if opts.get("words"):
        assert {4, 2 * trecog.MAX_CHAIN_V} <= {len(s["poly"]) for s in specs}
    if opts.get("negative_lefts"):
        assert any(s["box"][1] < 0 for s in specs) and any(c.rect.left < 0 for c in chars)
    if opts.get("padding"):
        assert sum(len(s["pos"]) for s in specs) > len(chars)
    if opts.get("empty"):
        kinds = [(len(s["pos"]) == 0, len(s["pos"]) > 0 and g is None) for s, g in zip(specs, got)]
        assert any(a for a, _ in kinds) and any(b for _, b in kinds)
    if opts.get("labels_outside"):
        assert any(c.char == "?" for c in chars) and any(c.char != "?" for c in chars)
    if opts.get("step_forms"):
        assert {isinstance(r.steps, list) for r in port} == {True, False}
    for i in opts.get("rotated", ()):
        assert port[i].line.rrect is not None and got[i] is not None
    if opts.get("mixed_lengths"):
        assert len({round(s["rec_len"] / s["ctc_len"]) for s in specs}) > 1
    assert chars, "every case assembles some chars"


def test_polygon_slice_bounding_rects_is_the_group_core_for_one_polygon():
    specs, _, _ = _group(3, seed=11, words=(1, 31))
    poly = specs[1]["poly"]
    assert len(poly) >= 120
    x0, x1 = int(poly[:, 0].min()), int(poly[:, 0].max())
    ranges = np.array([[x0 - 20, x0 - 1], [x0, x0 + 3], [x0 + 7, x0 + 60], [x1 - 2, x1 + 9], [x1 + 1, x1 + 5]])
    got = trecog.polygon_slice_bounding_rects(poly, ranges)
    want = jrecog.polygon_slice_bounding_rects(poly, ranges)
    as_tuples = lambda rs: [None if r is None else (r.top, r.left, r.bottom, r.right) for r in rs]
    assert as_tuples(got) == as_tuples(want)
    assert got[0] is None and got[-1] is None and all(r is not None for r in got[1:4])
    assert trecog.polygon_slice_bounding_rects(poly, ranges[:0]) == []
    assert trecog.polygon_slice_bounding_rects(poly[:0], ranges) == [None] * len(ranges)


def _pipeline_batches(specs, pages, rng):
    """Hand-made in-flight batches of a page group: greedy label frames of
    every line, lines of all pages mixed and out of index order."""
    by_len: dict = {}
    for i, s in enumerate(specs):
        by_len.setdefault((s["rec_len"], s["ctc_len"]), []).append(i)
    per_page = [[] for _ in range(pages)]
    inflight = []
    for (rec_len, ctc_len), idx in by_len.items():
        idx = [idx[j] for j in rng.permutation(len(idx))]
        frames = np.zeros((len(idx), ctc_len), np.uint8)
        batch = []
        for row, i in enumerate(idx):
            s = specs[i]
            # The spec's steps as frames (neighbours of one label merge).
            for p, lab in zip(s["pos"].tolist(), s["labels"].tolist()):
                frames[row, p] = max(lab, 1)
            pg = i % pages
            rl = trecog._RecLine(index=len(per_page[pg]), poly=s["poly"], rect=Rect.from_tlbr(*s["box"]),
                                 resized_width=s["resized"])
            per_page[pg].append(rl)
            batch.append((pg, rl))
        inflight.append((rec_len, batch, trecog._HostCopies((torch.from_numpy(frames), None, None))))
    return per_page, inflight


def test_pipeline_collects_a_group_as_each_page_alone():
    specs, _, _ = _group(45, seed=21, padding=True, empty=True, negative_lefts=True, mixed_lengths=True)
    pages = 4
    per_page, inflight = _pipeline_batches(specs, pages, np.random.default_rng(5))
    pipe = ot.PagePipeline(FakeDetectionModel(), FakeRecognitionModel(), ALPHABET, device="cpu")
    got = pipe._collect_recognition(per_page, inflight)
    # Each page alone, from the same frames.
    want: list = [[] for _ in range(pages)]
    jax_want: list = [[] for _ in range(pages)]
    for rec_len, batch, copies in inflight:
        (frames, _, _) = copies.numpy()
        for (pg, rl), (pos, lab) in zip(batch, collapse_greedy_batch_arrays(frames)):
            want[pg].append(trecog._LineResult(rl, rec_len, frames.shape[1], (pos, lab)))
            jl = jrecog._RecLine(rl.index, rl.poly, JaxRect.from_tlbr(rl.rect.top, rl.rect.left, rl.rect.bottom,
                                                                    rl.rect.right), rl.resized_width)
            jax_want[pg].append(jrecog._LineResult(jl, rec_len, frames.shape[1], (pos, lab)))
    assert len(got) == pages
    for pg in range(pages):
        want[pg].sort(key=lambda r: r.line.index)
        jax_want[pg].sort(key=lambda r: r.line.index)
        alone = trecog._text_lines_from_results(want[pg], ALPHABET)
        jax_alone = jrecog._text_lines_from_results(jax_want[pg], ALPHABET)
        assert len(got[pg]) == len(per_page[pg]) == len(alone)
        assert [_bits(l) for l in got[pg]] == [_bits(l) for l in alone] == [_bits(l) for l in jax_alone]
    assert sum(l is not None for page in got for l in page) > pages


@pytest.mark.parametrize("seed", [0, 1])
def test_json_and_text_output_are_byte_identical_to_jax(seed):
    _, port, jax = _group(20, seed=100 + seed, negative_lefts=True, padding=True, empty=True,
                          labels_outside=True, step_forms=True, rotated=(4,), mixed_lengths=True)
    lines = trecog._text_lines_from_results(port, ALPHABET)
    jlines = jrecog._text_lines_from_results(jax, ALPHABET)
    assert tout.format_text_output(lines) == jout.format_text_output(jlines)
    got = tout.format_json_output(tout.FormatJsonArgs("page.png", (900, 700), lines))
    want = jout.format_json_output(jout.FormatJsonArgs("page.png", (900, 700), jlines))
    assert got == want
    found = [l for l in lines if l is not None]
    assert sum(len(list(l.words())) for l in found) > len(found) > 5  # lines of several words


def _benchmark_group(seed=0):
    """A group shaped like the benchmark's 16 A4 pages: 337 lines of 2-5
    words and 14-35 chars each (the benchmark's: ~3.4 and ~24.6)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(337):
        s = _line_spec(rng, i % 80, {"words": (2, 3, 4, 5)})
        inside = -(-s["resized"] // 4)
        s["pos"] = np.sort(rng.choice(inside, size=min(int(rng.integers(14, 36)), inside), replace=False))
        s["pos"] = s["pos"].astype(np.int32)
        s["labels"] = rng.integers(1, len(ALPHABET) + 1, len(s["pos"])).astype(np.int32)
        specs.append(s)
    return specs, _results(specs, Rect, RotatedRect, trecog, CtcStep), _results(
        specs, JaxRect, JaxRotatedRect, jrecog, JaxCtcStep
    )


def main(reps: int = 15) -> None:
    specs, port, jax = _benchmark_group()
    chars = sum(len(s["pos"]) for s in specs)
    for name, fn, results in (
        ("port (ocrs_tpu_torch on sys.path)", trecog._text_lines_from_results, port),
        ("JAX package, line by line", jrecog._text_lines_from_results, jax),
    ):
        fn(results, ALPHABET)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(results, ALPHABET)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{name}: {len(results)} lines, {chars} chars: median {statistics.median(times):.2f} ms "
              f"(min {min(times):.2f}, max {max(times):.2f}, {reps} reps)")


if __name__ == "__main__":
    main()
