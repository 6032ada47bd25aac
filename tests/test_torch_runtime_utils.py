"""The port's small runtime modules against unilm_tpu on the CPU:
runtime/metrics.py, runtime/criterions.py (within 1e-6), runtime/
profiling.py, the sinks and the watchdog of runtime/logging.py, and the
iterators of data/iterators.py (the same items as the JAX iterators, and
states that equal theirs after a JSON round trip, at every checkpoint).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.data import iterators as jit_
from unilm_tpu.runtime import criterions as jcrit
from unilm_tpu.runtime import metrics as JM
from unilm_tpu_torch.data import iterators as tit
from unilm_tpu_torch.runtime import criterions as tcrit
from unilm_tpu_torch.runtime import logging as tlog
from unilm_tpu_torch.runtime import metrics as TM
from unilm_tpu_torch.runtime import profiling as tprof

torch.set_num_threads(1)
ATOL = 1e-6


# ---- metrics -----------------------------------------------------------------


def _scoped_run(M):
    M.reset_meters()
    with M.aggregate("train") as agg:
        M.log_scalar("loss", 2.0, weight=1)
        M.log_scalar("loss", 4.0, weight=3)
        with M.aggregate("inner") as inner:
            M.log_scalar("loss", 10.0)
            M.log_scalar("nll", 1.5, weight=2)
        M.log_derived("ppl", lambda d: 2 ** d["loss"])
    with M.aggregate("fresh", new_root=True) as fresh:
        M.log_scalar("loss", 7.0)
    return (agg.get_smoothed_values(), inner.get_smoothed_values(),
            fresh.get_smoothed_values(), M.get_smoothed_values("train"))


def test_metrics_scopes_match_jax():
    """Nested scopes, weights, derived values and new_root: the same
    smoothed values as the JAX module's."""
    got, want = _scoped_run(TM), _scoped_run(JM)
    assert got == want
    assert np.isclose(got[0]["loss"], 4.8) and np.isclose(got[0]["ppl"],
                                                          2 ** 4.8)
    assert got[2] == {"loss": 7.0}
    TM.reset_meters("train")
    assert TM.get_smoothed_values("train") == {}


def test_meters_match_jax():
    """SmoothedValue's median, window average and global average, and the
    AverageMeter, on one stream of values."""
    vals = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    for a, b in ((TM.SmoothedValue(5), JM.SmoothedValue(5)),):
        for i, v in enumerate(vals):
            a.update(v, n=i % 2 + 1)
            b.update(v, n=i % 2 + 1)
        assert (a.median, a.avg, a.global_avg) == (b.median, b.avg,
                                                   b.global_avg)
    m = TM.AverageMeter()
    m.update(1.0, 2.0)
    m.update(4.0, 1.0)
    assert m.avg == 2.0
    s = TM.SpeedMeter()
    s.update(10)
    time.sleep(0.01)
    assert 0 < s.avg < 10 / 0.01


# ---- criterions ---------------------------------------------------------------


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=1e-6)


def test_mlm_corruption_matches_jax_on_its_draws():
    """Given JAX's uniforms and random tokens, the port's corruption is
    JAX's apply_mlm_mask exactly; the port's own draws (a generator) keep
    the specials, mask about mask_prob, 80% of them to [MASK]."""
    rng = jax.random.PRNGKey(0)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 4, 100)
    tokens = tokens.at[:, 0].set(0)
    want = jcrit.apply_mlm_mask(rng, tokens, mask_token_id=103,
                                vocab_size=100, mask_prob=0.2)
    r1, r2, r3 = jax.random.split(rng, 3)
    draws = [torch.from_numpy(np.array(x)) for x in (
        jax.random.uniform(r1, tokens.shape),
        jax.random.uniform(r2, tokens.shape),
        jax.random.randint(r3, tokens.shape, 0, 100))]
    t = torch.from_numpy(np.array(tokens)).long()
    got = tcrit.mlm_corrupt(t, *draws, mask_token_id=103, mask_prob=0.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    corrupted, labels = tcrit.apply_mlm_mask(
        torch.Generator().manual_seed(0), t, mask_token_id=103,
        vocab_size=100, mask_prob=0.2)
    sel = (labels != tcrit.IGNORE).numpy()
    assert 0.1 < sel.mean() < 0.32 and not sel[:, 0].any()
    masked = (corrupted == 103).numpy() & sel
    assert masked.sum() / max(sel.sum(), 1) > 0.6
    np.testing.assert_array_equal(corrupted.numpy()[~sel], t.numpy()[~sel])


def test_losses_match_jax():
    """masked_lm_loss (perfect logits -> ~0), mim_loss and the
    label-smoothed NLL with and without an ignore index, against JAX."""
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 16, 50).astype(np.float32)
    tokens = rng.randint(0, 50, (4, 16))
    labels = np.where(rng.rand(4, 16) < 0.3, tokens, -100)
    mask = rng.rand(4, 16) < 0.4
    T = lambda x: torch.from_numpy(np.asarray(x))
    for got, want in (
            (tcrit.masked_lm_loss(T(logits), T(labels)),
             jcrit.masked_lm_loss(jnp.asarray(logits), jnp.asarray(labels))),
            (tcrit.mim_loss(T(logits), T(tokens), T(mask)),
             jcrit.mim_loss(jnp.asarray(logits), jnp.asarray(tokens),
                            jnp.asarray(mask))),
            (tcrit.label_smoothed_nll_loss(T(logits), T(tokens), 0.1),
             jcrit.label_smoothed_nll_loss(jnp.asarray(logits),
                                           jnp.asarray(tokens), 0.1)),
            (tcrit.label_smoothed_nll_loss(T(logits), T(labels), 0.2, -100),
             jcrit.label_smoothed_nll_loss(jnp.asarray(logits),
                                           jnp.asarray(labels), 0.2,
                                           -100))):
        _close(got[0], want[0])
        assert int(got[1]) == int(want[1])
    perfect = torch.nn.functional.one_hot(T(tokens), 50).float() * 100.0
    assert float(tcrit.masked_lm_loss(perfect, T(labels))[0]) < 1e-3


def test_xlco_and_xtune_match_jax():
    """XLCo's InfoNCE (loss, correct), the momentum update, the queue
    enqueue (ring wrap), and xTune's r1 / r2 losses with and without masks
    and hard labels, against JAX within 1e-6."""
    rng = np.random.RandomState(1)
    q, k = (rng.randn(6, 8).astype(np.float32) for _ in range(2))
    queue = rng.randn(12, 8).astype(np.float32)
    T = lambda x: torch.from_numpy(np.asarray(x))
    got = tcrit.xlco_loss(T(q), T(k), T(queue))
    want = jcrit.xlco_loss(jnp.asarray(q), jnp.asarray(k), jnp.asarray(queue))
    _close(got[0], want[0])
    assert int(got[1]) == int(want[1])

    fast = {"w": rng.randn(3, 2).astype(np.float32)}
    slow = {"w": rng.randn(3, 2).astype(np.float32)}
    got = tcrit.momentum_update({"w": T(fast["w"])}, {"w": T(slow["w"])}, 0.9)
    want = jcrit.momentum_update(fast, slow, 0.9)
    _close(got["w"], want["w"])

    keys = rng.randn(6, 8).astype(np.float32)
    tq, tp = T(queue), 0
    jq, jp = jnp.asarray(queue), jnp.asarray(0)
    for _ in range(3):  # 0, 6, then wraps to 0
        tq, tp = tcrit.queue_enqueue(tq, tp, T(keys))
        jq, jp = jcrit.queue_enqueue(jq, jp, jnp.asarray(keys))
        _close(tq, jq)
        assert tp == int(jp)

    a, b = (rng.randn(5, 7).astype(np.float32) for _ in range(2))
    m = np.array([True, False, True, True, False])
    for kw in ({}, {"r1_mask": m}):
        got = tcrit.xtune_r1_loss(T(a), T(b), **{k: T(v) for k, v in
                                                 kw.items()})
        want = jcrit.xtune_r1_loss(jnp.asarray(a), jnp.asarray(b),
                                   **{k: jnp.asarray(v) for k, v in
                                      kw.items()})
        _close(got, want)
    for kw in ({}, {"augmented_mask": m}, {"use_hard_labels": True}):
        tkw = {k: (T(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        _close(tcrit.xtune_r2_loss(T(a), T(b), **tkw),
               jcrit.xtune_r2_loss(jnp.asarray(a), jnp.asarray(b), **jkw))


# ---- profiling -----------------------------------------------------------------


def test_profiling_spans_and_trace(tmp_path):
    """named_scope and trace_annotation are record_function spans a
    profile sees; profile(dir) writes a Chrome trace there, profile(None)
    records nothing; StepTimer sums each span's wall time."""
    with tprof.profile(str(tmp_path)) as prof:
        with tprof.named_scope("fwd"):
            torch.ones(8).sum()
        with tprof.trace_annotation("host"):
            time.sleep(0.001)
    names = {e.key for e in prof.key_averages()}
    assert {"fwd", "host"} <= names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "fwd" for e in trace["traceEvents"])
    with tprof.profile(None) as none:
        assert none is None
    timer = tprof.StepTimer()
    for _ in range(2):
        with timer.span("step"):
            time.sleep(0.005)
    assert timer.totals["step"] >= 0.01


# ---- logging sinks and the watchdog --------------------------------------------


def test_step_watchdog_fires_and_resets():
    fired = []
    with tlog.StepWatchdog(0.2, on_timeout=lambda: fired.append(1)) as wd:
        for _ in range(4):
            time.sleep(0.08)
            wd.beat()
        assert not fired  # heartbeats keep it quiet
        time.sleep(0.5)
    assert fired  # a missed heartbeat fires the action


def test_sinks_wandb_noop_tensorboard_and_multi(tmp_path, monkeypatch):
    """W&B without wandb is a silent no-op (as in JAX); the TensorBoard
    sink writes `tag/key` scalars through torch.utils.tensorboard's
    SummaryWriter (a stand-in module here: the real one imports
    TensorFlow, seconds of start-up) and skips values that are not
    numbers, and is a no-op without tensorboard; MultiLogger fans out and
    drops None sinks."""
    import sys
    import types

    monkeypatch.setitem(sys.modules, "wandb", None)
    wb = tlog.WandbLogger("proj")
    wb.log({"loss": 1.0}, step=0)
    wb.flush()

    calls = []

    class Writer:
        def __init__(self, logdir):
            calls.append(("init", logdir))

        def add_scalar(self, name, value, step):
            calls.append((name, value, step))

        def flush(self):
            calls.append(("flush",))

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    tb = tlog.TensorboardLogger(str(tmp_path / "tb"))
    tb.log({"loss": 1.5, "name": "x"}, step=1)
    tb.flush()
    assert calls == [("init", str(tmp_path / "tb")), ("train/loss", 1.5, 1),
                     ("flush",)]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    off = tlog.TensorboardLogger(str(tmp_path / "off"))
    off.log({"loss": 1.5}, step=1)
    off.flush()
    assert off._writer is None and len(calls) == 3

    path = tmp_path / "log.jsonl"
    multi = tlog.MultiLogger(tlog.JsonlLogger(str(path)), None, wb)
    assert len(multi.loggers) == 2
    multi.log({"loss": 2.5}, step=3, tag="valid")
    rec = json.loads(path.read_text().strip())
    assert rec["loss"] == 2.5 and rec["step"] == 3 and rec["tag"] == "valid"


# ---- iterators ------------------------------------------------------------------


def _same_streams(make_t, make_j, n_take=40, step=7):
    """The port's pipeline yields JAX's items; at every step-th position
    its state equals JAX's (JSON round trip) and resumes a fresh pipeline
    on the same tail."""
    tr, jr = make_t(), make_j()
    ref = [next(jr) for _ in range(n_take)]
    assert [next(tr) for _ in range(n_take)] == ref
    for k in range(0, n_take, step):
        tp, jp = make_t(), make_j()
        for _ in range(k):
            next(tp), next(jp)
        st = json.loads(json.dumps(tp.getstate()))
        assert st == json.loads(json.dumps(jp.getstate())), k
        fresh = make_t()
        fresh.setstate(st)
        assert [next(fresh) for _ in range(n_take - k)] == ref[k:], k
        for p in (tp, jp, fresh):
            p.close()


def test_native_chunked_and_zip_match_jax():
    _same_streams(lambda: tit.NativeCheckpointableIterator(list(range(100))),
                  lambda: jit_.NativeCheckpointableIterator(list(range(100))))
    for r in range(3):
        _same_streams(
            lambda: tit.ChunkedSourceIterator(list(range(10)), 3, r),
            lambda: jit_.ChunkedSourceIterator(list(range(10)), 3, r),
            n_take=3 + (r == 0), step=1)
    parts = [x for r in range(3)
             for x in tit.ChunkedSourceIterator(list(range(10)), 3, r)]
    assert sorted(parts) == list(range(10))

    def zipped(m):
        return m.ZipIterator(
            m.InfinitePermutationSourceIterator(list(range(7)), seed=1),
            m.MapIterator(m.NativeCheckpointableIterator(list(range(60))),
                          lambda x: x * 3))

    _same_streams(lambda: zipped(tit), lambda: zipped(jit_))


@pytest.mark.parametrize("by", ["tokens", "size"])
def test_bucketed_readahead_matches_jax(by):
    """Token budget (padded size max_len x items <= 32) or a fixed batch
    size over a sorted, shuffled read-ahead window: JAX's batches and
    states at every checkpoint."""
    budget = (dict(batch_size_tokens=32) if by == "tokens"
              else dict(batch_size=3))

    def make(m):
        src = m.InfinitePermutationSourceIterator(
            [{"len": (i % 13) + 1, "id": i} for i in range(40)], seed=2)
        return m.BucketedReadaheadBatchIterator(
            src, read_ahead=16, key=lambda x: x["len"], seed=4, **budget)

    _same_streams(lambda: make(tit), lambda: make(jit_))
    b = make(tit)
    for _ in range(20):
        batch = next(b)
        if by == "tokens":
            assert (max(x["len"] for x in batch) * len(batch) <= 32
                    or len(batch) == 1)
        else:
            assert len(batch) <= 3


def test_prefetch_checkpointing_matches_jax():
    """A background-thread prefetch: its state is the consumer's position
    (JAX's state), and a fresh pipeline resumed from it yields the rest."""
    def make(m):
        return m.PrefetchIterator(
            m.InfinitePermutationSourceIterator(list(range(30)), seed=7),
            buffer_size=4)

    ref_it = make(jit_)
    ref = [next(ref_it) for _ in range(40)]
    ref_it.close()
    pipe, jpipe = make(tit), make(jit_)
    assert [next(pipe) for _ in range(13)] == ref[:13]
    for _ in range(13):
        next(jpipe)
    state = json.loads(json.dumps(pipe.getstate()))
    assert state == json.loads(json.dumps(jpipe.getstate()))
    pipe.close()
    jpipe.close()
    pipe2 = make(tit)
    pipe2.setstate(state)
    tail = [next(pipe2) for _ in range(27)]
    pipe2.close()
    assert tail == ref[13:]


def test_epoch_batch_iterator_matches_jax_and_resumes():
    """Two epochs of length-bucketed, shuffled batches equal JAX's (its
    `native.batch_by_size` against the port's copy); five batches,
    state_dict, a fresh iterator resumes on the rest."""
    data = [[i] * (i % 7 + 1) for i in range(23)]

    def run(m):
        ref = m.EpochBatchIterator(data, key=len, max_tokens=16, seed=3)
        return [[x[0] for x in b] for _ in range(2)
                for b in ref.next_epoch_itr()]

    seq = run(tit)
    assert seq == run(jit_)
    a = tit.EpochBatchIterator(data, key=len, max_tokens=16, seed=3)
    gen = a.next_epoch_itr()
    head = [[x[0] for x in next(gen)] for _ in range(5)]
    state = json.loads(json.dumps(a.state_dict()))
    b = tit.EpochBatchIterator(data, key=len, max_tokens=16, seed=3)
    b.load_state_dict(state)
    tail = [[x[0] for x in bb] for _ in range(2) for bb in b.next_epoch_itr()]
    assert head + tail == seq
    from unilm_tpu import native

    lengths = np.random.RandomState(0).randint(1, 40, 50)
    for kw in (dict(max_tokens=64), dict(max_sentences=4),
               dict(max_tokens=100, bsz_multiple=2)):
        got = tit.batch_by_size(lengths, **kw)
        want = native.batch_by_size(lengths, **kw)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
