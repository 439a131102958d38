"""Inference session: bucketed batches through the compiled forward.

The port of ``InferenceSession`` in ``flexflow_tpu/serving/session.py``,
the session every serving front end wraps. Requests of any row count are
padded with zero rows up to the nearest batch bucket, run through
``Executor.make_forward`` (``infer``) or ``FFModel.generate`` /
``generate_beam`` (``generate``) and sliced back; batches larger than the
largest bucket run in bucket-sized chunks. Long greedy decodes run in
segments with the instance lock released between them. ``infer`` and
``generate`` are the firing sites of the ``infer_fail@N`` /
``infer_crash@N`` fault clauses (``resilience/faults.py``): one call
index per top-level call. Request tracing comes with the serving
fronts.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..resilience import faults

_NP_DTYPES = {torch.bool: np.bool_, torch.int8: np.int8,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float32: np.float32, torch.float64: np.float64}


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class InferenceSession:
    """Wraps a compiled FFModel for serving."""

    def __init__(self, ff, batch_buckets: Sequence[int] = (1, 4, 16, 64),
                 decode_segment: int = 32):
        if ff.executor is None:
            raise ValueError("compile() the model first")
        self.ff = ff
        self.buckets = sorted(set(int(b) for b in batch_buckets))
        # greedy decodes longer than this run in decode_segment-token
        # segments, releasing the instance lock between them, so short
        # infer() calls on this instance are not starved for a whole
        # generation; 0 = one lock hold
        self.decode_segment = int(decode_segment)
        self._fwd = ff.executor.make_forward()
        self._lock = threading.Lock()

    def clone(self) -> "InferenceSession":
        """A concurrent instance of the same model: shares the forward
        and the parameters, carries its own dispatch lock."""
        c = InferenceSession.__new__(InferenceSession)
        c.ff = self.ff
        c.buckets = self.buckets
        c.decode_segment = self.decode_segment
        c._fwd = self._fwd
        c._lock = threading.Lock()
        return c

    @property
    def input_names(self) -> List[str]:
        return [t.name for t in self.ff.graph_inputs]

    @property
    def input_signature(self) -> Dict[str, Tuple[Tuple[int, ...],
                                                 np.dtype]]:
        """name -> (compile-time shape, numpy dtype) of each graph input;
        ``shape[0]`` is the compile-time batch size."""
        return {t.name: (tuple(t.shape),
                         np.dtype(_NP_DTYPES[t.torch_dtype]))
                for t in self.ff.graph_inputs}

    def infer(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """Run one batch; pads to the bucket and slices the result.
        Batches larger than the biggest bucket run in bucket-sized
        chunks. Client errors (missing inputs, ragged rows) raise
        ValueError."""
        if faults.active():
            faults.raise_infer_fault()
        return self._infer_checked(inputs)

    def _infer_checked(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        # chunk recursion goes through here, NOT infer(): the fault
        # hook must advance the infer_fail@N counter exactly once per
        # top-level call or clause indices stop matching request counts
        names = self.input_names
        missing = [n for n in names if n not in inputs]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        n = int(next(iter(inputs.values())).shape[0])
        cap = self.buckets[-1]
        if n > cap:
            return np.concatenate(
                [self._infer_checked(
                    {k: v[i:i + cap] for k, v in inputs.items()})
                 for i in range(0, n, cap)], axis=0)
        bucket = _next_bucket(n, self.buckets)
        padded = {}
        for name in names:
            arr = np.ascontiguousarray(inputs[name])
            if arr.shape[0] != n:
                raise ValueError(f"ragged batch: {name} has "
                                 f"{arr.shape[0]} rows, want {n}")
            if bucket != n:
                pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad], axis=0)
            padded[name] = arr
        with self._lock:  # one forward of this model at a time
            out = self._fwd(self.ff.params, self.ff.state, padded)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()[:n]

    def generate(self, input_ids: np.ndarray,
                 prompt_len: "int | np.ndarray",
                 max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0,
                 eos_token_id: "int | None" = None,
                 top_k: int = 0, top_p: float = 1.0,
                 num_beams: int = 1) -> np.ndarray:
        """Autoregressive decode for causal-LM sessions; returns the
        completed ids as a numpy int32 array. ``prompt_len`` may be a
        per-row (batch,) array (ragged prompts). The batch is padded to
        the bucket (padded ragged rows decode from a 1-token prompt) and
        the padded rows' outputs are sliced off; ``num_beams`` > 1 runs
        ``FFModel.generate_beam``."""
        # same fault hook as infer(): generate IS the serving path a
        # chaos plan (infer_fail@N / infer_crash@N) must reach. Each
        # bucket-sized chunk of an oversized batch advances the call
        # counter once (chunks are separate generate calls), as in the
        # JAX package.
        if faults.active():
            faults.raise_infer_fault()
        ids = np.ascontiguousarray(np.asarray(input_ids, np.int32))
        n = int(ids.shape[0])
        ragged = np.ndim(prompt_len) > 0
        if ragged:
            if num_beams > 1:
                raise ValueError("per-row prompt lengths are not "
                                 "supported with beam search; send "
                                 "uniform-length beams or one request "
                                 "per row")
            prompt_len = np.asarray(prompt_len, np.int32)
        cap = self.buckets[-1]
        if n > cap:
            # per-chunk seed: identical prompts in different chunks must
            # not draw identical sampling streams; the wide-stride fold
            # keeps chunk 1 of this request apart from a request that
            # uses seed + 1
            return np.concatenate(
                [self.generate(ids[i:i + cap],
                               prompt_len[i:i + cap] if ragged
                               else prompt_len,
                               max_new_tokens, temperature,
                               (seed + (i // cap) * 0x9E3779B1)
                               & 0x7FFFFFFF, eos_token_id,
                               top_k=top_k, top_p=top_p,
                               num_beams=num_beams)
                 for i in range(0, n, cap)], axis=0)
        bucket = _next_bucket(n, self.buckets)
        if bucket != n:
            pad = np.zeros((bucket - n,) + ids.shape[1:], ids.dtype)
            ids = np.concatenate([ids, pad], axis=0)
            if ragged:
                # padded rows decode from a dummy 1-token prompt
                prompt_len = np.concatenate(
                    [prompt_len, np.ones(bucket - n, np.int32)])
        seg = self.decode_segment
        if (num_beams == 1 and temperature == 0.0 and not top_k
                and top_p >= 1.0 and 0 < seg < max_new_tokens):
            # greedy decode is deterministic, so it can run in bounded
            # segments with the lock released between them; sampling
            # keeps the single hold (its random stream is one loop's)
            return self._generate_segmented(ids, prompt_len,
                                            max_new_tokens, seg,
                                            eos_token_id, ragged)[:n]
        with self._lock:
            if num_beams > 1:
                # beam search is deterministic: temperature, top-k and
                # top-p do not apply
                out = self.ff.generate_beam(ids, prompt_len,
                                            max_new_tokens,
                                            num_beams=num_beams,
                                            eos_token_id=eos_token_id)
            else:
                out = self.ff.generate(ids, prompt_len, max_new_tokens,
                                       temperature=temperature, seed=seed,
                                       eos_token_id=eos_token_id,
                                       top_k=top_k, top_p=top_p)
        return out.cpu().numpy()[:n]

    def _generate_segmented(self, ids: np.ndarray, prompt_len,
                            max_new_tokens: int, seg: int, eos_token_id,
                            ragged: bool) -> np.ndarray:
        """Greedy decode in bounded lock-hold segments: each segment
        continues from the previous one's ids with the prompt length
        advanced. Its K/V of the tokens an earlier segment decoded come
        from a fresh prefill, so it gives the single hold's tokens up to
        rounding (in bf16 two runs can part where two tokens' scores
        nearly tie). Rows that emitted ``eos`` in
        an earlier segment have their later columns forced back to
        ``eos`` on the host, which is what the done-mask does inside one
        segment (rows are independent under causal attention, so a
        finished row's forced columns cannot change its neighbours)."""
        out = np.asarray(ids)
        b, L = out.shape
        plen = (np.asarray(prompt_len, np.int32) if ragged
                else int(prompt_len))
        done = np.zeros(b, bool)
        col = np.arange(L)[None, :]
        offset, remaining = 0, int(max_new_tokens)
        while remaining > 0:
            step = min(seg, remaining)
            cur = plen + offset
            with self._lock:
                out = self.ff.generate(out, cur, step, temperature=0.0,
                                       eos_token_id=eos_token_id
                                       ).cpu().numpy()
            if eos_token_id is not None:
                starts = np.asarray(cur, np.int64) if ragged \
                    else np.full(b, cur, np.int64)
                seg_cols = (col >= starts[:, None]) \
                    & (col < (starts + step)[:, None])
                if done.any():
                    out[done[:, None] & seg_cols] = eos_token_id
                done |= np.where(seg_cols, out == eos_token_id,
                                 False).any(axis=1)
            offset += step
            remaining -= step
        return out
