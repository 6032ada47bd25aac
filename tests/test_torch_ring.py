"""Port parity for ring attention and sequence parallelism
(unilm_tpu_torch.parallel.ring_attention / long_context, and the
cfg.seq_axis route of core/attention.py) on gloo CPU ranks.

Four ranks run in one spawn (tests/torch_dist_workers.py, a FileStore
under tmp_path, one thread a rank) and hold their shards' results; here
they are held against JAX's `ring_attention_flash` under shard_map on 4
of the 8 forced CPU devices (interpret mode), and against dense attention
where the port diverges from JAX. Tolerances (float32): outputs 1e-5,
gradients 1e-4, relative (and as absolute floors).

The non-contiguous mask: example 0 is left-padded inside chunks 1 and 2,
so rows there see no key of their own (diagonal) chunk while the chunk
has valid keys. JAX's `_chunk_dead_fix` only notices whole-chunk padding
and shrinks those rows (a fault of the reference, pinned below); the
port takes each row's aliveness and equals dense attention. Example 2
masks every key: its rows are zeros with zero gradients, not NaN.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_workers as W
from unilm_tpu.parallel import make_mesh
from unilm_tpu.parallel.ring_attention import ring_attention_flash

torch.set_num_threads(1)
WORLD = 4
CASES = ("causal", "masked", "noncontig")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.spawn("ring_cases", WORLD, tmp_path_factory.mktemp("ring"),
                   cases=CASES)


def _gather(ranks, case, key):
    return np.concatenate([r[case][key].numpy() for r in ranks], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_ring(case):
    q, k, v, g, mask = W.ring_inputs(case, WORLD)
    causal = case != "masked"
    mesh = make_mesh({"data": -1}, devices=jax.devices()[:WORLD])
    spec = P(None, "data")
    ring = shard_map(
        lambda q, k, v, m: ring_attention_flash(q, k, v, m, "data", causal,
                                                None, 512, 512, True),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, check_rep=False)
    m = jnp.ones(q.shape[:2], jnp.int32) if mask is None else jnp.asarray(
        mask.astype(np.int32))
    f = lambda q, k, v: jnp.sum(ring(q, k, v, m) * g)
    out = jax.jit(lambda q, k, v: ring(q, k, v, m))(q, k, v)
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _dense(case):
    """Float64 dense attention and its grads (torch autograd) with the
    case's causal / key-padding mask; a row with no visible key is 0."""
    q, k, v, g, mask = W.ring_inputs(case, WORLD)
    causal = case != "masked"
    T, D = q.shape[1], q.shape[-1]
    ts = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    s = torch.einsum("bthd,bshd->bhts", ts[0] * D ** -0.5, ts[1])
    keep = torch.ones(T, T, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    keep = keep[None, None]
    if mask is not None:
        keep = keep & torch.from_numpy(mask)[:, None, None, :]
    s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, -1) * keep.any(-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p, ts[2])
    (o * torch.from_numpy(g).double()).sum().backward()
    return (o.detach().numpy(), [t.grad.numpy() for t in ts],
            keep.any(-1)[:, 0].numpy())  # alive [B, T]


@pytest.mark.parametrize("case", ["causal", "masked"])
def test_ring_flash_matches_jax(ranks, case):
    jout, jgrads = _jax_ring(case)
    np.testing.assert_allclose(_gather(ranks, case, "out"), jout,
                               rtol=1e-5, atol=1e-5)
    for name, jg in zip(("dq", "dk", "dv"), jgrads):
        np.testing.assert_allclose(_gather(ranks, case, name), jg,
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_plain_ring_matches_dense(ranks):
    want, _, _ = _dense("causal")
    np.testing.assert_allclose(
        np.concatenate([r["plain"].numpy() for r in ranks], 1), want,
        rtol=1e-5, atol=1e-5)


def test_noncontiguous_mask_matches_dense_where_jax_shrinks_rows(ranks):
    want, wgrads, alive = _dense("noncontig")
    out = _gather(ranks, "noncontig", "out")
    for name, wg in zip(("dq", "dk", "dv"), wgrads):
        got = _gather(ranks, "noncontig", name)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, wg, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    assert not alive[2].any() and (out[2] == 0).all()
    assert (_gather(ranks, "noncontig", "dq")[2] == 0).all()
    # the reference's fault: rows 8-10 and 20 of example 0 see no key of
    # their diagonal chunk, which has valid keys; JAX merges the kernel's
    # (0, lse 0) for them and shrinks the row
    jout, _ = _jax_ring("noncontig")
    rows = [8, 9, 10, 20]
    assert np.abs(jout[0, rows] - want[0, rows]).max() > 1e-2
    others = [t for t in range(out.shape[1]) if t not in rows]
    np.testing.assert_allclose(jout[:2][:, others], want[:2][:, others],
                               rtol=1e-5, atol=1e-5)


def test_seq_parallel_lm_steps_match_one_rank(ranks, tmp_path):
    """SeqParallelLM (cfg.seq_axis through the ring, xPos at global
    positions, the cross-shard targets) trains 2 steps on 4 ranks with the
    loss, grad norm and parameters of the same model on one rank."""
    from unilm_tpu_torch.core.config import TransformerConfig
    from unilm_tpu_torch.parallel.long_context import SeqParallelLM
    from unilm_tpu_torch.runtime.optim import AdamW
    from unilm_tpu_torch.runtime.train import TrainState, make_train_step

    cfg_kw = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
                  ffn_dim=64, max_positions=64, xpos_rel_pos=True,
                  subln=True, use_flash=False)
    got = W.spawn("seq_lm_step", WORLD, tmp_path, cfg_kw=cfg_kw, steps=2)
    lm = SeqParallelLM(TransformerConfig(**cfg_kw))
    lm.init_weights(torch.Generator().manual_seed(11))
    toks = torch.from_numpy(np.random.RandomState(12).randint(
        3, 64, size=(2, 8 * WORLD)))
    tx = AdamW(1e-3)
    state = TrainState.create(lm, tx)
    step = make_train_step(lm.loss_fn, tx, clip_grad_norm=1.0,
                           grad_sync=lm)
    for i in range(2):
        state, m = step(state, toks)
        for r in got:
            for key in ("loss", "grad_norm", "ntok"):
                np.testing.assert_allclose(r["metrics"][i][key],
                                           float(m[key]), rtol=1e-5,
                                           err_msg=f"step {i} {key}")
    for n, p in lm.named_parameters():
        for r in got:
            np.testing.assert_allclose(r["params"][n].numpy(),
                                       p.detach().numpy(), atol=1e-5,
                                       err_msg=n)


def test_activation_footprint_is_jaxs():
    from unilm_tpu.core.config import TransformerConfig as JCfg
    from unilm_tpu.parallel.long_context import (
        activation_footprint_bytes as jfoot)
    from unilm_tpu_torch.core.config import TransformerConfig as TCfg
    from unilm_tpu_torch.parallel.long_context import (
        activation_footprint_bytes as tfoot)

    kw = dict(vocab_size=65037, embed_dim=2048, num_layers=24, num_heads=32,
              ffn_dim=8192)
    for remat in (True, False):
        assert tfoot(TCfg(**kw), 4, 32768, remat) == jfoot(
            JCfg(**kw), 4, 32768, remat)
