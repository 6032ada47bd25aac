"""Port parity for native/__init__.py's host ops and scoring.py's
scorers against unilm_tpu on the same inputs: the port's numpy ops equal
the JAX package's numpy fallbacks (its `get_lib` patched to None), and,
where the g++ library computes the same function (every op but the
balanced assignment, whose library is an auction), the library as
well. BleuScorer, box_iou and grounding_recall equal JAX's; every
comparison is exact."""

import numpy as np
import pytest

from unilm_tpu import native as jnative
from unilm_tpu import scoring as jscoring
from unilm_tpu_torch import native as tnative
from unilm_tpu_torch import scoring as tscoring
from unilm_tpu_torch.data import iterators as tit


@pytest.fixture(params=["fallback", "library"])
def ref(request, monkeypatch):
    """JAX's native module as its numpy fallback or with the library."""
    if request.param == "fallback":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    elif jnative.get_lib() is None:
        pytest.fail("the JAX package's g++ library did not build")
    return request.param


def _seqs(seed, n=20, hi=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 5, rng.randint(0, hi)).tolist() for _ in range(n)]


def test_edit_distance_and_bleu_counts(ref):
    a, b = _seqs(0), _seqs(1)
    assert [tnative.edit_distance(x, y) for x, y in zip(a, b)] == [
        jnative.edit_distance(x, y) for x, y in zip(a, b)]
    np.testing.assert_array_equal(tnative.edit_distance_batch(a, b),
                                  jnative.edit_distance_batch(a, b))
    ct, cj = np.zeros(8, np.int64), np.zeros(8, np.int64)
    for x, y in zip(a, b):
        tnative.bleu_counts(x, y, ct)
        jnative.bleu_counts(x, y, cj)
    np.testing.assert_array_equal(ct, cj)
    assert tscoring.edit_distance is tnative.edit_distance


@pytest.mark.parametrize("mode", [None, "none", "complete", "complete_doc",
                                  "eos"])
def test_token_blocks(ref, mode):
    rng = np.random.RandomState(2)
    sizes = rng.randint(1, 9, 40)
    sizes[[5, 17, 30]] = 1  # document separators for complete_doc
    s = tnative.token_block_slices(sizes, mode, block_size=16)
    np.testing.assert_array_equal(
        s, jnative.token_block_slices(sizes, mode, block_size=16))
    np.testing.assert_array_equal(tnative.block_to_dataset_index(sizes, s),
                                  jnative.block_to_dataset_index(sizes, s))


def test_batch_by_size_is_jaxs(ref):
    lengths = np.random.RandomState(3).randint(1, 20, 50)
    for kw in (dict(max_tokens=40), dict(max_sentences=7),
               dict(max_tokens=64, bsz_multiple=4)):
        got = tnative.batch_by_size(lengths, **kw)
        want = jnative.batch_by_size(lengths, **kw)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert tnative.batch_by_size is tit.batch_by_size


def test_balanced_assignment_is_jaxs_fallback(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    scores = np.random.RandomState(4).rand(32, 4).astype(np.float32)
    out = tnative.balanced_assignment(scores)
    np.testing.assert_array_equal(out, jnative.balanced_assignment(scores))
    assert (np.bincount(out, minlength=4) == 8).all()


def test_bleu_scorer_is_jaxs(ref):
    pairs = [("the cat sat on the mat", "the cat sat on the mat"),
             ("the cat sat on the mat", "the cat sat on the hat"),
             ("a b c d e f", "a b c d x f"), ("one two", "one")]
    for n in range(1, len(pairs) + 1):
        st, sj = tscoring.BleuScorer(), jscoring.BleuScorer()
        for r, h in pairs[:n]:
            st.add_string(r, h)
            sj.add_string(r, h)
        assert st.score() == sj.score()
    st, sj = tscoring.BleuScorer(), jscoring.BleuScorer()
    st.add([1, 2, 3, 4, 5], [1, 2, 3, 4, 6])
    sj.add([1, 2, 3, 4, 5], [1, 2, 3, 4, 6])
    assert st.score() == sj.score() > 0


def test_box_iou_and_grounding_recall_are_jaxs():
    rng = np.random.RandomState(5)
    boxes = [tuple(np.sort(rng.rand(2)).tolist() + np.sort(rng.rand(2))
                   .tolist()) for _ in range(12)]
    boxes = [(b[0], b[2], b[1], b[3]) for b in boxes] + [(0, 0, 0, 0)]
    for a in boxes:
        for b in boxes:
            assert tscoring.box_iou(a, b) == jscoring.box_iou(a, b)
    preds = [boxes[i:i + 3] for i in range(10)]
    refs = boxes[:10]
    for thr, k in ((0.5, 1), (0.3, 2), (0.9, 3)):
        assert (tscoring.grounding_recall(preds, refs, thr, k)
                == jscoring.grounding_recall(preds, refs, thr, k))
