"""Inference sessions and the model repository.

The port of ``flexflow_tpu/serving/session.py``. ``InferenceSession`` is
the session every serving front end wraps. Requests of any row count are
padded with zero rows up to the nearest batch bucket, run through
``Executor.make_forward`` (``infer``) or ``FFModel.generate`` /
``generate_beam`` (``generate``) and sliced back; batches larger than the
largest bucket run in bucket-sized chunks. Long greedy decodes run in
segments with the instance lock released between them. ``infer`` and
``generate`` are the firing sites of the ``infer_fail@N`` /
``infer_crash@N`` fault clauses (``resilience/faults.py``): one call
index per top-level call. When a front has activated a request trace
(``obs.request_trace``), ``generate`` adds its batch, queue and
decode-segment stages to it.

``ServingPlanSession`` routes each batch to the per-bucket model of a
searched serving plan (``search/serving_plan.py``);
``build_serving_plan_session`` compiles one model per bucket and, on the
card, keeps a bucket's plain model where it decodes faster (the floor
guard). ``ModelRepository`` is the name -> instances registry the fronts
serve, with loaders for serialized graphs (``frontends/torch_fx.py``)
and ONNX models (``frontends/onnx_frontend.py``).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import request_trace
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
        # over a world of ranks a batch pads to a multiple of the rows'
        # data-parallel blocks as well as to its bucket
        self._row_blocks = ff.executor.row_blocks()

    def clone(self) -> "InferenceSession":
        """A concurrent instance of the same model: shares the forward
        and the parameters, carries its own dispatch lock."""
        c = InferenceSession.__new__(InferenceSession)
        c.ff = self.ff
        c.buckets = self.buckets
        c.decode_segment = self.decode_segment
        c._fwd = self._fwd
        c._lock = threading.Lock()
        c._row_blocks = self._row_blocks
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

    def _padded_rows(self, n: int) -> int:
        """The rows a batch of ``n`` runs at: its bucket, rounded up over
        a world of ranks to a multiple of the rows' data-parallel
        blocks."""
        r = self._row_blocks
        return -(-_next_bucket(n, self.buckets) // r) * r

    def check_infer(self, inputs: Dict[str, np.ndarray]) -> int:
        """The rows of a request ``infer`` takes; ValueError for one it
        refuses (missing inputs, ragged rows), before any device work."""
        names = self.input_names
        missing = [n for n in names if n not in inputs]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        n = int(next(iter(inputs.values())).shape[0])
        for name in names:
            rows = int(np.shape(inputs[name])[0])
            if rows != n:
                raise ValueError(f"ragged batch: {name} has {rows} rows, "
                                 f"want {n}")
        return n

    def check_generate(self, input_ids, prompt_len, max_new_tokens: int,
                       num_beams: int = 1) -> None:
        """ValueError for a request ``generate`` refuses (ids not (rows,
        positions), a prompt length out of range, ragged prompts with
        beams), before any device work."""
        from ..model import check_prompt
        shape = np.shape(input_ids)
        if len(shape) != 2:
            raise ValueError(f"input_ids must be (rows, positions), got "
                             f"shape {shape}")
        if int(num_beams) < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        if np.ndim(prompt_len) > 0 and num_beams > 1:
            raise ValueError("per-row prompt lengths are not supported "
                             "with beam search; send uniform-length beams "
                             "or one request per row")
        check_prompt(shape[0], shape[1], prompt_len, max_new_tokens)

    def _infer_checked(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        # chunk recursion goes through here, NOT infer(): the fault
        # hook must advance the infer_fail@N counter exactly once per
        # top-level call or clause indices stop matching request counts
        names = self.input_names
        n = self.check_infer(inputs)
        cap = self.buckets[-1]
        if n > cap:
            return np.concatenate(
                [self._infer_checked(
                    {k: v[i:i + cap] for k, v in inputs.items()})
                 for i in range(0, n, cap)], axis=0)
        bucket = self._padded_rows(n)
        padded = {}
        for name in names:
            arr = np.ascontiguousarray(inputs[name])
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
        # the ambient request trace (set by an HTTP front): batch
        # padding, the instance-lock wait and the decode segments link
        # into the request
        trace = request_trace.current()
        t_pad = time.perf_counter()
        bucket = self._padded_rows(n)
        if bucket != n:
            pad = np.zeros((bucket - n,) + ids.shape[1:], ids.dtype)
            ids = np.concatenate([ids, pad], axis=0)
            if ragged:
                # padded rows decode from a dummy 1-token prompt
                prompt_len = np.concatenate(
                    [prompt_len, np.ones(bucket - n, np.int32)])
        if trace is not None:
            trace.stage("batch", t_pad, bucket=str(bucket), rows=n)
        seg = self.decode_segment
        if (num_beams == 1 and temperature == 0.0 and not top_k
                and top_p >= 1.0 and 0 < seg < max_new_tokens):
            # greedy decode is deterministic, so it can run in bounded
            # segments with the lock released between them; sampling
            # keeps the single hold (its random stream is one loop's)
            return self._generate_segmented(ids, prompt_len,
                                            max_new_tokens, seg,
                                            eos_token_id, ragged)[:n]
        t_lock = time.perf_counter()
        with self._lock:
            if trace is not None:
                trace.stage("queue", t_lock, bucket=str(bucket))
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
        trace = request_trace.current()
        seg_idx = 0
        offset, remaining = 0, int(max_new_tokens)
        while remaining > 0:
            step = min(seg, remaining)
            cur = plen + offset
            t_wait = time.perf_counter()
            with self._lock:
                if trace is not None and seg_idx == 0:
                    # the first acquisition is the request's queue time
                    trace.stage("queue", t_wait, bucket=str(b))
                t_step = time.perf_counter()
                out = self.ff.generate(out, cur, step, temperature=0.0,
                                       eos_token_id=eos_token_id
                                       ).cpu().numpy()
            if trace is not None:
                trace.stage("decode_segment", t_step, segment=seg_idx,
                            tokens=step, bucket=str(b))
            seg_idx += 1
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


class ServingPlanSession:
    """Bucket-routed instances of a searched serving plan
    (``search/serving_plan.optimize_serving_strategy``).

    One compiled model per batch bucket, each imported from the plan's
    per-bucket sub-strategy, so each batch class runs its own plan.
    Duck-typed to :class:`InferenceSession` (``infer`` / ``generate`` /
    ``clone`` / ``input_names`` / ``input_signature`` / ``buckets`` /
    ``ff``), so :class:`~.scheduler.BatchScheduler` and both HTTP fronts
    serve it unchanged."""

    def __init__(self, sessions: Dict[int, InferenceSession]):
        if not sessions:
            raise ValueError("need at least one bucket session")
        self._by_bucket = {int(b): s for b, s in dict(sessions).items()}
        self.buckets = sorted(self._by_bucket)
        # the floor guard's per-bucket decisions when it ran
        # (build_serving_plan_session): bucket -> {searched_s,
        # baseline_s, adopted}
        self.floor_guard: Dict = {}

    @property
    def ff(self):
        """The largest bucket's model, the one the serving envelope was
        verified at."""
        return self._by_bucket[self.buckets[-1]].ff

    def session_for(self, n: int) -> InferenceSession:
        """The per-bucket instance a batch of ``n`` rows routes to."""
        return self._by_bucket[_next_bucket(n, self.buckets)]

    @property
    def input_names(self) -> List[str]:
        return self._by_bucket[self.buckets[-1]].input_names

    @property
    def input_signature(self):
        return self._by_bucket[self.buckets[-1]].input_signature

    def check_infer(self, inputs: Dict[str, np.ndarray]) -> int:
        n = int(next(iter(inputs.values())).shape[0])
        return self.session_for(n).check_infer(inputs)

    def check_generate(self, input_ids, prompt_len, max_new_tokens: int,
                       num_beams: int = 1) -> None:
        n = int(np.shape(input_ids)[0]) if np.ndim(input_ids) else 0
        self.session_for(n).check_generate(input_ids, prompt_len,
                                           max_new_tokens, num_beams)

    def infer(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        n = int(next(iter(inputs.values())).shape[0])
        # oversized batches ride the largest bucket's own chunking
        return self.session_for(n).infer(inputs)

    def generate(self, input_ids: np.ndarray,
                 prompt_len: "int | np.ndarray",
                 max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0, eos_token_id: "int | None" = None,
                 top_k: int = 0, top_p: float = 1.0,
                 num_beams: int = 1) -> np.ndarray:
        n = int(np.asarray(input_ids).shape[0])
        return self.session_for(n).generate(
            input_ids, prompt_len, max_new_tokens,
            temperature=temperature, seed=seed,
            eos_token_id=eos_token_id, top_k=top_k, top_p=top_p,
            num_beams=num_beams)

    def clone(self) -> "ServingPlanSession":
        c = ServingPlanSession(
            {b: s.clone() for b, s in self._by_bucket.items()})
        c.floor_guard = self.floor_guard
        return c

    def measured_profile(self) -> Dict[str, Dict]:
        """Measured decode per bucket, keyed as the serving audit's
        ``predicted`` entries: bucket label -> ``{prefill_s,
        decode_step_s, n}`` from each bucket model's
        ``_decode_measured``. Buckets that have served no generate
        traffic yet are absent."""
        out: Dict[str, Dict] = {}
        for b, s in self._by_bucket.items():
            rec = getattr(s.ff, "_decode_measured", {}).get(int(b))
            if rec:
                out[str(b)] = dict(rec)
        return out


class NoDecodePath(RuntimeError):
    """The model has no KV decode path to time: the serving floor guard
    does not apply to it."""


def _min_decode_latency(ff, bucket: int, reps: int = 3) -> float:
    """Least measured per-token decode-step time of ``ff`` at ``bucket``
    rows, read from ``ff._decode_measured`` (the KV decode times prefill
    and decode apart, each ending in a device sync). The first call
    warms up and is not timed; the record keeps its earlier entries.
    Raises :class:`NoDecodePath` when the graph has no KV decode path
    (callers treat that as 'guard not applicable'); any other failure
    propagates. Over a world of ranks the bucket's rows round up to a
    multiple of the rows' data-parallel blocks, as a session pads them."""
    r = ff.executor.row_blocks()
    bucket = -(-int(bucket) // r) * r
    names = {t.name for t in ff.graph_inputs}
    if "input_ids" not in names or not ff._kv_decode_eligible(names,
                                                               None):
        raise NoDecodePath("the graph has no KV decode path (inputs "
                           f"{sorted(names)})")
    t = next(t for t in ff.graph_inputs if t.name == "input_ids")
    seq = int(t.shape[1])
    plen = max(1, seq // 4)
    new_tokens = max(1, min(8, seq - plen))
    ids = np.zeros((bucket, seq), np.int32)
    ff.generate(ids, plen, new_tokens, temperature=0.0)
    rec = ff.__dict__.setdefault("_decode_measured", {})
    best = float("inf")
    for _ in range(reps):
        before = rec.pop(bucket, None)
        ff.generate(ids, plen, new_tokens, temperature=0.0)
        now = rec.get(bucket)
        if now is None:
            raise NoDecodePath(f"generate at {bucket} rows recorded no "
                               f"decode measurement (it fell back to "
                               f"the re-forward)")
        best = min(best, now["decode_step_s"])
        if before is not None:
            rec[bucket] = {
                "prefill_s": min(before["prefill_s"], now["prefill_s"]),
                "decode_step_s": min(before["decode_step_s"],
                                     now["decode_step_s"]),
                "n": before["n"] + now["n"]}
    return best


def _rank0_value(value):
    """``value`` as rank 0 holds it, on every rank of a world of ranks
    (a host object over the default group); ``value`` itself outside
    one."""
    from ..parallel.distributed import is_initialized, process_count
    if not is_initialized() or process_count() <= 1:
        return value
    import torch.distributed as dist
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def build_serving_plan_session(serving_strategy_file: str, build,
                               floor_guard: str = "auto"
                               ) -> ServingPlanSession:
    """One compiled model per bucket of a serving-plan file: each
    bucket's sub-strategy is extracted into a standalone single-bucket
    strategy document (``serving_plan.bucket_strategy_doc``) and imported
    through the ordinary strategy-file path. ``build(sf, buckets=...)``
    compiles one session from a strategy file (``sf=None`` = the model as
    it loads without a serving plan, the baseline the floor guard
    compares against).

    ``floor_guard`` (``FFConfig.serving_floor_guard``): per bucket, a few
    greedy decodes of the imported plan and of the baseline run back to
    back, and the bucket keeps whichever measures faster (records in
    ``ServingPlanSession.floor_guard``). "auto" runs it when the models
    live on a CUDA device and skips it on the CPU. A model with no KV
    decode path keeps the searched plan and records why
    (``{"skipped": ...}``); any other failure, a device error among
    them, fails the load.

    Over a world of ranks every rank makes this call, each bucket's
    model compiles over the world (its plan's mesh must be the world's),
    and the floor guard's choice is rank 0's on every rank. A plan that
    shards a bucket's KV cache over the context is refused."""
    import json
    import os
    import tempfile

    from ..search.serving_plan import bucket_strategy_doc
    with open(serving_strategy_file) as f:
        doc = json.load(f)
    sblock = doc.get("serving") or {}
    bks = sorted(int(k) for k in (sblock.get("buckets") or {}))
    if not bks:
        raise ValueError(
            f"{serving_strategy_file} has no serving block: search one "
            f"with optimize_serving_strategy (mode='serving') or pass it "
            f"as strategy_file")
    seq_kv = [b for b in bks if any(
        int((kv or {}).get("seq_shard_degree", 1) or 1) > 1
        for kv in (sblock["buckets"][str(b)].get("kv") or {}).values())]
    if seq_kv:
        raise NotImplementedError(
            f"buckets {seq_kv} of {serving_strategy_file} shard the KV "
            f"cache over the context (seq_shard_degree > 1): that needs a "
            f"mesh with a seq axis and a combine of the partial attention "
            f"outputs each decode step, not ported (ROADMAP queue 1 item "
            f"4.6's leftover)")
    per_bucket = {}
    for b in bks:
        sub = bucket_strategy_doc(doc, b)
        fd, p = tempfile.mkstemp(suffix=f".bucket{b}.json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(sub, f)
            per_bucket[b] = build(p, buckets=[b])
        finally:
            try:
                os.unlink(p)
            except OSError:
                pass

    mode = str(floor_guard or "auto").lower()
    guard = mode not in ("false", "off", "0", "no")
    if guard and mode == "auto":
        guard = any(s.ff.device.type == "cuda"
                    for s in per_bucket.values())
    records = {}
    if guard:
        from ..obs import events as obs_events
        t0 = time.perf_counter()
        try:
            base = build(None, buckets=list(bks))
            for b in bks:
                # over a world every rank times both (the decodes are
                # collective) and rank 0's times decide for all of them
                t_s, t_b = _rank0_value(
                    (_min_decode_latency(per_bucket[b].ff, b),
                     _min_decode_latency(base.ff, b)))
                adopted = "searched" if t_s <= t_b else "baseline"
                if adopted == "baseline":
                    per_bucket[b] = InferenceSession(
                        base.ff, [b],
                        decode_segment=per_bucket[b].decode_segment)
                records[b] = {"searched_s": t_s, "baseline_s": t_b,
                              "adopted": adopted}
        except NoDecodePath as e:
            records = {"skipped": repr(e)[:200]}
        obs_events.record_span(
            "serving.floor_guard", t0, time.perf_counter() - t0,
            buckets=len(bks))
    session = ServingPlanSession(per_bucket)
    session.floor_guard = records
    return session


class ModelRepository:
    """Name -> session-instances registry (Triton's model repository and
    instance groups).

    Each model may have N concurrent instances (session clones); the
    HTTP layer gives all of them to one :class:`~.scheduler.
    BatchScheduler`, whose per-instance workers drain a shared bounded
    queue. Models load and unload by name at run time. The loaders
    compile on ``config.device`` (``FFConfig().device``, "cuda", unless
    the caller's config asks for the CPU)."""

    def __init__(self):
        self._models: Dict[str, List[InferenceSession]] = {}

    def register(self, name: str, session: InferenceSession,
                 instances: "int | None" = None):
        """Register a model. Pass a list of sessions OR ``instances=N``
        to clone one session N times: clones share the forward and the
        weights and carry their own dispatch locks."""
        if isinstance(session, (list, tuple)):
            self._models[name] = list(session)
        elif instances and instances > 1:
            self._models[name] = [session] + [
                session.clone() for _ in range(int(instances) - 1)]
        else:
            self._models[name] = [session]

    def unload(self, name: str):
        """Remove a model by name (Triton ``.../unload``)."""
        if name not in self._models:
            raise KeyError(f"model {name!r} not loaded")
        del self._models[name]

    def load_graph(self, name: str, path: str,
                   input_shapes: Sequence[Sequence[int]],
                   checkpoint_dir: Optional[str] = None,
                   batch_buckets: Sequence[int] = (1, 4, 16, 64),
                   config=None, strategy_file=None, instances: int = 1,
                   serving_strategy_file=None):
        """Serve a serialized graph (``PyTorchModel.torch_to_file``
        output) without its source framework: rebuild it through
        ``file_to_ff``, optionally restore trained weights from a
        checkpoint, and register an eval session.

        ``strategy_file`` imports a searched strategy instead of plain
        data parallelism; a LIST (one entry per instance, None = DP)
        compiles each instance separately. A single value with
        ``instances=N`` compiles once and clones."""
        from ..frontends.torch_fx import PyTorchModel

        def graph_build(ff):
            ins = [ff.create_tensor(tuple(s), name=f"in{i}")
                   for i, s in enumerate(input_shapes)]
            outs = PyTorchModel.file_to_ff(path, ff, ins)
            return outs[0]

        return self._load_with_builder(
            name, graph_build, batch_buckets=batch_buckets, config=config,
            strategy_file=strategy_file, instances=instances,
            checkpoint_dir=checkpoint_dir,
            serving_strategy_file=serving_strategy_file)

    def load_onnx(self, name: str, path_or_model,
                  input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                  checkpoint_dir: Optional[str] = None,
                  batch_buckets: Sequence[int] = (1, 4, 16, 64),
                  config=None, strategy_file=None, instances: int = 1,
                  serving_strategy_file=None):
        """Serve an ONNX model: rebuild the graph through
        ``frontends.onnx_frontend.ONNXModel``, copy the initializer
        weights after compile, and register sessions. ``input_shapes``
        maps graph-input name -> shape (required for inputs with
        symbolic dims); ``strategy_file`` / ``instances`` behave as in
        :meth:`load_graph`."""
        from ..ffconst import DataType
        from ..frontends.onnx_frontend import ONNXModel
        model = ONNXModel(path_or_model)
        graph = model.model.graph
        fed = [vi for vi in graph.input
               if vi.name not in model.initializers]
        # elem_type -> framework dtype (TensorProto enum values)
        dt_map = {1: DataType.DT_FLOAT, 6: DataType.DT_INT32,
                  7: DataType.DT_INT64, 9: DataType.DT_BOOLEAN,
                  10: DataType.DT_HALF, 16: DataType.DT_BFLOAT16}

        def shape_of(vi):
            if input_shapes and vi.name in input_shapes:
                return tuple(int(d) for d in input_shapes[vi.name])
            dims = []
            for d in vi.type.tensor_type.shape.dim:
                if d.dim_param or d.dim_value <= 0:
                    raise ValueError(
                        f"ONNX input {vi.name!r} has a symbolic dim "
                        f"{d.dim_param or '?'}: pass input_shapes")
                dims.append(int(d.dim_value))
            return tuple(dims)

        def onnx_build(ff):
            ins = {vi.name: ff.create_tensor(
                shape_of(vi), name=vi.name,
                dtype=dt_map.get(vi.type.tensor_type.elem_type,
                                 DataType.DT_FLOAT)) for vi in fed}
            outs = model.apply(ff, ins)
            return outs[0]

        return self._load_with_builder(
            name, onnx_build, batch_buckets=batch_buckets, config=config,
            strategy_file=strategy_file, instances=instances,
            checkpoint_dir=checkpoint_dir,
            post_compile=model.copy_weights,
            serving_strategy_file=serving_strategy_file)

    def _load_with_builder(self, name, graph_build, batch_buckets,
                           config, strategy_file, instances,
                           checkpoint_dir=None, post_compile=None,
                           serving_strategy_file=None):
        """Shared per-instance loading: one compiled session per
        strategy-file entry (None = plain DP), or one session cloned
        ``instances`` times.

        ``serving_strategy_file`` adopts a searched per-batch-class
        serving plan: one model is compiled per bucket and requests
        route by batch size through a :class:`ServingPlanSession`.
        Mutually exclusive with ``strategy_file``.

        The config's ``compilation_cache_dir`` is left unused: the JAX
        package points XLA's persistent compile cache there on every
        load, and the port has no per-load compile to cache (its kernels
        are built once into ``build/kernels/``)."""
        import copy

        from ..config import FFConfig
        from ..model import FFModel
        from ..runtime.optimizers import SGDOptimizer

        if serving_strategy_file and strategy_file:
            raise ValueError("pass strategy_file OR "
                             "serving_strategy_file, not both")
        per_instance = isinstance(strategy_file, (list, tuple))
        files = (list(strategy_file) if per_instance
                 else [strategy_file])
        if per_instance and instances != 1 and instances != len(files):
            raise ValueError(
                f"instances={instances} conflicts with "
                f"{len(files)} per-instance strategy files: the list "
                f"length alone sets the instance count")

        def build(sf, buckets=batch_buckets):
            cfg = copy.deepcopy(config) if config is not None \
                else FFConfig()
            if sf:
                cfg.import_strategy_file = sf
                cfg.only_data_parallel = False
            else:
                cfg.only_data_parallel = True
                # a None entry means plain DP for THIS instance: clear
                # any import the caller's config carried
                cfg.import_strategy_file = ""
            ff = FFModel(cfg)
            ff._model_name = name   # labels compile/fallback counters
            out = graph_build(ff)
            ff.compile(SGDOptimizer(0.0), "identity", [],
                       output_tensor=out)
            if post_compile is not None:
                post_compile(ff)
            if checkpoint_dir:
                from ..runtime.checkpoint import restore_model_checkpoint
                restore_model_checkpoint(ff, checkpoint_dir)
            return InferenceSession(ff, buckets)

        if serving_strategy_file:
            session = build_serving_plan_session(
                serving_strategy_file, build,
                floor_guard=getattr(config, "serving_floor_guard",
                                    "auto") if config is not None
                else "auto")
            self.register(name, session, instances=instances)
            return session

        sessions = [build(sf) for sf in files]
        if per_instance:
            self.register(name, sessions)
        else:
            self.register(name, sessions[0], instances=instances)
        return sessions[0]

    def hot_swap(self, name: str, session, instances: "int | None" = None,
                 scheduler=None, deadline_s: float = 10.0):
        """Replace a loaded model's instances in place, the adoption
        point for a re-searched serving plan. With ``scheduler`` (the
        model's :class:`~.scheduler.BatchScheduler`) the swap rides the
        graceful-drain path: admission pauses (503 + ``Retry-After``),
        the admitted backlog flushes on the OLD instances, then workers
        restart on the new ones. Without a scheduler it is a bare
        registry swap."""
        if name not in self._models:
            raise KeyError(f"model {name!r} not loaded "
                           f"(have {list(self._models)})")
        self.register(name, session, instances=instances)
        if scheduler is not None:
            scheduler.hot_swap(self.get_instances(name),
                               deadline_s=deadline_s)
        return self.get(name)

    def get(self, name: str) -> InferenceSession:
        """First (primary) instance: the single-session API."""
        return self.get_instances(name)[0]

    def get_instances(self, name: str) -> List[InferenceSession]:
        if name not in self._models:
            raise KeyError(
                f"model {name!r} not loaded (have {list(self._models)})")
        return self._models[name]

    def names(self) -> List[str]:
        return list(self._models)
