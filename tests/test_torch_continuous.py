"""The port's continuous batcher (``serving/fleet/continuous.py``) against the
JAX package's sequential oracle and its own.

The contract (the JAX package's ``continuous.py``): every sequence's row
equals ``session.generate(row[None], plen, max_new_tokens,
temperature=0.0, eos_token_id=eos)[0]``, whichever neighbours shared its
iterations. Here the reference tests' tiny GPT-2 (vocab 64, hidden 32, 2
layers, 32 positions, f32) is built in both packages with the JAX weights
carried into the port: the port's rows equal the JAX oracle's token for
token, and the port's own sequential ``generate`` bit for bit, under
continuous, staggered mid-flight and static admission. The policy tests
(expiry, close, validation) run on a fake fixed-step session so the
iteration arithmetic is exact.
"""
import threading
import time

import numpy as np
import pytest
import torch

import flexflow_tpu.serving as jserving
import flexflow_tpu_torch.serving as tserving
from flexflow_tpu.search.serving_plan import kv_cache_bytes as jkv_bytes
from flexflow_tpu.serving.fleet import kv_slot_capacity as jkv_slots
from flexflow_tpu_torch.executor import DECODE_ROW_CHUNK
from flexflow_tpu_torch.serving.fleet import (ContinuousBatcher,
                                              EngineClosedError,
                                              SequenceError,
                                              kv_slot_capacity)
from flexflow_tpu_torch.search.serving_plan import kv_cache_bytes

from _torch_serving import gpt2_pair

CAP, SEQ, SEG, EOS = 4, 32, 4, 63


@pytest.fixture(scope="module")
def sessions():
    jff, tff = gpt2_pair(batch=CAP, seq=SEQ)
    return (jserving.InferenceSession(jff, batch_buckets=(1, CAP),
                                      decode_segment=SEG),
            tserving.InferenceSession(tff, batch_buckets=(1, CAP),
                                      decode_segment=SEG))


def _work(n=10, seed=0):
    """Ragged prompts, alternating short and long budgets."""
    rng = np.random.RandomState(seed)
    work = []
    for k in range(n):
        plen = 2 + int(rng.randint(0, 5))
        max_new = 2 if k % 2 == 0 else 14
        ids = np.zeros(SEQ, np.int32)
        ids[:plen] = 1 + rng.randint(0, 50, size=plen)
        work.append((ids, plen, max_new))
    return work


def _oracle(sess, ids, plen, max_new):
    return np.asarray(sess.generate(ids[None], prompt_len=plen,
                                    max_new_tokens=max_new,
                                    temperature=0.0, eos_token_id=EOS))[0]


def _check(got, work, *wants):
    for k, ((_, plen, mnew), g) in enumerate(zip(work, got)):
        for want in wants:
            np.testing.assert_array_equal(
                g[:plen + mnew], want[k][:plen + mnew],
                err_msg=f"sequence {k}")


def test_rows_match_jax_oracle_and_own_generate(sessions):
    jsess, tsess = sessions
    work = _work()
    want_j = [_oracle(jsess, *w) for w in work]
    want_t = [_oracle(tsess, *w) for w in work]
    cb = ContinuousBatcher(tsess, capacity=CAP, eos_token_id=EOS)
    try:
        got = [s.wait(timeout_s=120.0)
               for s in [cb.submit(*w) for w in work]]
        st = cb.stats()
    finally:
        cb.close()
    _check(got, work, want_t, want_j)
    assert st["completed"] == len(work)
    # slot turnover: fewer iterations than one batch at a time would take
    assert st["iterations"] < sum(-(-m // SEG) for _, _, m in work)


def test_staggered_midflight_admission_bit_exact(sessions):
    jsess, tsess = sessions
    work = _work(n=8, seed=3)
    want_t = [_oracle(tsess, *w) for w in work]
    want_j = [_oracle(jsess, *w) for w in work]
    cb = ContinuousBatcher(tsess, capacity=CAP, eos_token_id=EOS)
    try:
        first = [cb.submit(*w) for w in work[:CAP]]
        time.sleep(0.05)
        late = []
        for w in work[CAP:]:
            late.append(cb.submit(*w))
            time.sleep(0.02)
        got = [s.wait(timeout_s=120.0) for s in first + late]
        midflight = sum(s.admitted_midflight for s in first + late)
    finally:
        cb.close()
    _check(got, work, want_t, want_j)
    assert midflight >= 1


def test_static_admission_bit_exact_and_convoys(sessions):
    jsess, tsess = sessions
    work = _work(n=8, seed=5)
    want_t = [_oracle(tsess, *w) for w in work]
    want_j = [_oracle(jsess, *w) for w in work]
    stats = {}
    for mode in ("static", "continuous"):
        cb = ContinuousBatcher(tsess, capacity=CAP, eos_token_id=EOS,
                               admission=mode)
        try:
            got = [s.wait(timeout_s=120.0)
                   for s in [cb.submit(*w) for w in work]]
            stats[mode] = cb.stats()
        finally:
            cb.close()
        _check(got, work, want_t, want_j)
    assert stats["continuous"]["iterations"] <= \
        stats["static"]["iterations"]


def test_plan_session_bucket_pinned_once(sessions):
    _, tsess = sessions
    picked = []

    class PlanLike:
        buckets = [CAP]

        def session_for(self, n):
            picked.append(n)
            return tsess

    work = _work(n=4, seed=9)
    want = [_oracle(tsess, *w) for w in work]
    cb = ContinuousBatcher(PlanLike(), capacity=CAP, eos_token_id=EOS)
    try:
        got = [cb.submit(*w).wait(timeout_s=120.0) for w in work]
    finally:
        cb.close()
    assert picked == [CAP]
    _check(got, work, want)


def test_kv_slot_capacity_matches_jax(sessions):
    jsess, tsess = sessions
    per_j = sum(jkv_bytes(l, 1, SEQ) for l in jsess.ff.layers)
    per_t = sum(kv_cache_bytes(l, 1, SEQ) for l in tsess.ff.layers)
    assert per_t == per_j > 0
    for budget, cap in ((3 * per_t, 64), (0, 64), (10 ** 12, 8),
                        (5 * per_t + 1, 64)):
        assert kv_slot_capacity(tsess.ff, budget, hard_cap=cap) == \
            jkv_slots(jsess.ff, budget, hard_cap=cap)
    cb = ContinuousBatcher(tsess, kv_cache_bytes_budget=3 * per_t,
                           eos_token_id=EOS)
    try:
        assert cb.capacity == 3
    finally:
        cb.close()


class _FakeFF:
    """next token = (previous + 1) % 64, on the host."""

    def __init__(self):
        class T:
            name = "input_ids"
            shape = (CAP, SEQ)
        self.graph_inputs = [T()]

    def generate(self, ids, cur, step, temperature=0.0, eos_token_id=None):
        out = np.array(ids, np.int32)
        for r in range(out.shape[0]):
            c = int(cur[r])
            for j in range(step):
                out[r, c + j] = (out[r, c + j - 1] + 1) % 64
        return out


class _FakeSession:
    decode_segment = SEG

    def __init__(self, step_s=0.0):
        self.ff = _FakeFF()
        self._lock = threading.Lock()
        inner = self.ff.generate

        def slow(*a, **k):
            time.sleep(step_s)
            return inner(*a, **k)
        self.ff.generate = slow


def test_expired_before_admission_never_runs():
    cb = ContinuousBatcher(_FakeSession(), capacity=2, eos_token_id=EOS)
    try:
        ids = np.zeros(SEQ, np.int32)
        ids[0] = 1
        s = cb.submit(ids, 1, 4, timeout_s=-1.0)
        with pytest.raises(TimeoutError):
            s.wait(timeout_s=10.0)
        assert cb.stats()["expired"] == 1
        assert cb.stats()["iterations"] == 0
    finally:
        cb.close()


def test_close_fails_pending_and_rejects_submit():
    cb = ContinuousBatcher(_FakeSession(step_s=0.2), capacity=2,
                           eos_token_id=EOS)
    ids = np.zeros(SEQ, np.int32)
    ids[0] = 1
    seqs = [cb.submit(ids, 1, 20) for _ in range(4)]
    time.sleep(0.05)
    cb.close()
    for s in seqs:
        with pytest.raises(EngineClosedError):
            s.wait(timeout_s=10.0)
    with pytest.raises(EngineClosedError):
        cb.submit(ids, 1, 4)


def test_early_eviction_forces_eos_columns():
    """A row that emits eos is evicted at the segment boundary with its
    remaining budget forced to eos on the host, the oracle's reading."""
    cb = ContinuousBatcher(_FakeSession(), capacity=2, eos_token_id=EOS,
                           decode_segment=2)
    try:
        ids = np.zeros(SEQ, np.int32)
        ids[0] = EOS - 2          # emits 62, 63 (= eos), then 0 ...
        out = cb.generate(ids, 1, 10, timeout_s=30.0)
        st = cb.stats()
    finally:
        cb.close()
    assert out[1:3].tolist() == [EOS - 1, EOS]
    assert (out[3:11] == EOS).all() and (out[11:] == 0).all()
    assert st["evicted_early"] == 1 and st["iterations"] == 1


def test_submit_validation():
    cb = ContinuousBatcher(_FakeSession(), capacity=2, eos_token_id=EOS)
    try:
        ids = np.zeros(SEQ, np.int32)
        for args in ((ids, 0, 4), (ids, 1, SEQ),
                     (np.zeros(SEQ + 1, np.int32), 1, 4)):
            with pytest.raises(SequenceError):
                cb.submit(*args)
        with pytest.raises(ValueError):
            ContinuousBatcher(_FakeSession(), capacity=2,
                              admission="fifo")
    finally:
        cb.close()


def _decode_step_products(tff, rows, chunk):
    """One KV decode step (position 6 after a 6-token prefill) of the
    first ``rows`` of eight (or more) seeded sequences, with the decode
    context's row chunk set to ``chunk`` and every product logged:
    (scores (rows, V), log)."""
    ex = tff.executor
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        1, 60, (max(rows, 8), SEQ)).astype(np.int32))[:rows]
    batch = {"input_ids": ids,
             "position_ids": torch.arange(SEQ, dtype=torch.int32)[None]
             .expand(rows, -1)}
    cache = ex.kv_prefill(tff.params, tff.state, batch, prefill_len=6)
    log, make_ctx = [], ex._kv_ctx

    def logged(mode, state):
        ctx = make_ctx(mode, state)
        ctx.product_log, ctx.row_chunk = log, chunk
        return ctx

    ex._kv_ctx = logged
    try:
        scores, _ = ex.kv_decode_step(
            tff.params, tff.state, {k: v[:, 6:7] for k, v in batch.items()},
            cache, 6)
    finally:
        del ex._kv_ctx
    return scores, log


def test_decode_step_products_run_at_a_fixed_row_chunk(sessions):
    """Every product of a KV decode step (the projections, both batched
    attention products, the MLP and the LM head) is issued on blocks of
    the executor's row chunk, whether the batch holds 1 row or 8, so a
    row meets the same GEMM shapes either way; its scores are then the
    same bits alone and among 8, and among 72 (two chunks), and the f32
    scores equal the unchunked step's to f32 rounding."""
    tff = sessions[1].ff
    chunk = DECODE_ROW_CHUNK
    assert chunk == 64
    assert tff.executor._kv_ctx("decode", tff.state).row_chunk == chunk
    got = {rows: _decode_step_products(tff, rows, chunk) for rows in (1, 8)}
    issued = {rows: [s for p in log for s in p["issued"]]
              for rows, (_, log) in got.items()}
    # 2 layers x (q, k, v, scores, context, output projection, 2 MLP) + head
    assert len(got[1][1]) == len(got[8][1]) == 17
    assert issued[1] == issued[8]
    for a_shape, b_shape in issued[1]:
        assert a_shape[0] == chunk, (a_shape, b_shape)
        if len(b_shape) == 3:          # a batched product: chunk entries
            assert b_shape[0] == chunk, (a_shape, b_shape)
    one, eight = got[1][0], got[8][0]
    assert torch.equal(one[0], eight[0])
    many, log = _decode_step_products(tff, 72, chunk)
    assert many.shape == (72, one.shape[1])
    assert all(a[0] == chunk for p in log for a, _ in p["issued"])
    assert torch.equal(many[:8], eight)
    for rows in (1, 8):
        plain, log = _decode_step_products(tff, rows, 0)
        assert [p["issued"][0][0][0] for p in log[:3]] == [rows] * 3
        # another GEMM shape sums in another order: equal to f32 rounding,
        # at the generation tests' tolerance
        torch.testing.assert_close(plain, got[rows][0], rtol=0, atol=1e-5)
