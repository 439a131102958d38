"""Strategy optimization entry point: dispatches to the configured search.

The port of ``flexflow_tpu/search/optimizer.py``; the reference's ``Graph::graph_optimize_task`` (``src/runtime/
graph.cc:2046``): builds the cost model over the machine model,
calibrates it on the card, runs the search (Unity by default, MCMC under
``search_algo="mcmc"``), writes the strategy audit, and keeps plain data
parallelism when the searched program measures slower on the card (the
DP floor guard). Honors ``--budget``, ``--import`` / ``--export``.

On the card the calibration runs the bf16 matmul chain
(``OpCostModel.calibrate``), turns on per-op measurement, and with
``calibration_v2`` measures the host and attention-impl rows
(``search/calibration.py``); a CUDA failure in any of them raises.
``mode="serving"`` dispatches to the serving search
(``search/serving_plan.py``). Refused with ``NotImplementedError``
naming the ROADMAP item: pipeline search, banked placement, quantized
gradient collectives, overlap-aware scoring, hierarchical placement on a
multi-tier machine, and the task-graph simulator
(``machine_model_version >= 1``).
"""
from __future__ import annotations

import json
import logging
import time

from ..obs import audit as obs_audit
from ..obs import events as obs_events
from ..parallel.strategy import ShardingStrategy
from .costmodel import OpCostModel, _backend
from .mcmc import (assignment_to_strategy, data_parallel_assignment,
                   mcmc_search)
from .serialization import load_strategy, save_strategy

_ITEM4 = "ROADMAP queue 1 item 4 (the parallel lowering)"
_ITEM5 = "ROADMAP queue 1 item 5 (the rest of the strategy search)"


def _on(value, default: str = "auto") -> str:
    return str(value if value is not None else default).strip().lower()


def _refuse_unported(cfg, dmesh) -> None:
    """The JAX search's multi-device refinements, when asked for."""
    asked = []
    qs = _on(getattr(cfg, "quantized_collectives", "off"), "off")
    if qs not in ("off", "", "false", "no", "0", "disable", "disabled"):
        asked.append((f"quantized_collectives={qs!r}", _ITEM4))
    if _on(getattr(cfg, "overlap", "auto")) in ("on", "true", "1", "yes"):
        asked.append(("overlap", _ITEM4))
    if getattr(cfg, "enable_pipeline_search", False):
        asked.append(("enable_pipeline_search", _ITEM5))
    if _on(getattr(cfg, "banked_placement", "auto")) in (
            "on", "true", "1", "yes", "force"):
        asked.append(("banked_placement", _ITEM5))
    if getattr(cfg, "machine_model_version", 0) >= 1:
        asked.append(("machine_model_version >= 1 (the task-graph "
                      "simulator, tasksim.py)", _ITEM5))
    hier = _on(getattr(cfg, "hier_placement", "auto"))
    if dmesh.spec.tier_graph.multi_tier and hier not in (
            "false", "off", "0", "no"):
        asked.append(("hierarchical placement on a multi-tier machine "
                      "(set hier_placement='false' to price it flat)",
                      _ITEM4))
    if asked:
        raise NotImplementedError(
            "not ported: " + "; ".join(f"{what} [{item}]"
                                       for what, item in asked))


def optimize_strategy(ff, mode: str = "train"):
    """ff: FFModel (post graph construction, pre executor build).

    Returns ``(strategy, program_info_or_None)``: Unity search may rewrite
    the graph (inserting parallel ops), in which case ``program_info``
    carries the new executable layer list — the analog of the reference's
    ``convert_graph_to_operators`` output replacing the original
    operators.

    ``mode="serving"`` runs the serving search
    (``search/serving_plan.py``): one plan per batch bucket ranked by
    prefill + per-token decode-step latency with the KV cache resident
    in the envelope. It needs a compiled model and returns the largest
    bucket's strategy; the per-bucket plan lands on ``ff._serving_plan``
    and in the ``--export`` file's ``serving`` block."""
    cfg = ff.config
    if mode == "serving":
        from .serving_plan import optimize_serving_strategy
        plan = optimize_serving_strategy(ff)
        return plan.largest.strategy, None
    if mode != "train":
        raise ValueError(f"unknown strategy-search mode {mode!r} "
                         f"(expected 'train' or 'serving')")
    dmesh = ff.dmesh
    # stale-path guard: if THIS search's audit write is skipped (tracing
    # off) or fails, the floor guard below must not annotate a previous
    # compile's record with this compile's measured timings
    ff._strategy_audit_path = None
    if cfg.import_strategy_file:
        return _import_strategy(ff, cfg.import_strategy_file, dmesh)
    _refuse_unported(cfg, dmesh)
    cost_model = OpCostModel(dmesh.spec)
    cost_model.device = ff.device
    cost_model.segment_size = max(1, cfg.simulator_segment_size)
    cost_model.max_segments = max(1, cfg.simulator_max_num_segments)
    # the kernel planner (FFModel._plan_kernels) re-prices against the
    # SAME calibrated model the search scored the strategy with
    ff._search_cost_model = cost_model
    phases = ff.__dict__.setdefault("_compile_phases", {})
    t_cal = time.perf_counter()
    with obs_events.span("search.calibrate"):
        if _backend(dmesh) == "cuda":
            # the card: refine the tensor-core efficiency with a bf16
            # matmul chain AND time every heavy op at shard-local shape
            # (the analog of measure_operator_cost, simulator.cc:537).
            # On the CPU the analytic cpu-sim constants stand.
            cost_model.calibrate(ff.device)
            cost_model.measure_on_device = True
        # under --machine-model-file the described machine's constants
        # are the ground truth: never overwrite them with measurements
        if not cfg.machine_model_file:
            cost_model.calibrate_collectives(dmesh)
            from .calibration import calibrate_mesh, calibration_enabled
            if calibration_enabled(cfg):
                cost_model.attach_calibration(calibrate_mesh(dmesh))
    # kernel tier (kernels/registry.py): grow the impl-keyed calibration
    # rows (a warm table measures nothing) and price every attention op
    # at its cheapest AVAILABLE impl during the search. Gated on an
    # attached calibration, as in the JAX package: without measured
    # evidence the defaults stand.
    from ..kernels.registry import resolve_forced
    kpolicy = _on(getattr(cfg, "kernel_impls", "auto"))
    if kpolicy not in ("off", "none") and cost_model.calib is not None:
        forced = resolve_forced(cfg)
        from .calibration import calibrate_kernel_impls
        calibrate_kernel_impls(dmesh, cost_model.calib.table)
        cost_model.attach_kernel_tier(dmesh, forced=forced)
    t0 = time.perf_counter()
    phases["calibrate_s"] = round(t0 - t_cal, 3)
    if cfg.search_algo == "unity":
        result = _unity(ff, cost_model, t0)
        phases["unity_s"] = round(time.perf_counter() - t0, 3)
        return _apply_floor_guard(ff, result)
    budget = cfg.search_budget if cfg.search_budget > 0 else 500
    best, best_cost, sim = mcmc_search(
        ff.layers, dmesh, cost_model, budget=budget,
        alpha=max(cfg.search_alpha - 1.0, 0.01), seed=cfg.seed,
        verbose=cfg.profiling)
    dp = data_parallel_assignment(ff.layers, dmesh, sim.options)
    dp_cost = sim.evaluate(dp).total
    _write_mcmc_audit(ff, sim, best, dp)
    strategy = assignment_to_strategy(ff.layers, ff.graph_inputs, best,
                                      dmesh, sim)
    if cfg.profiling:
        print(f"search: {time.perf_counter() - t0:.2f}s, "
              f"best {best_cost * 1e3:.3f} ms vs DP {dp_cost * 1e3:.3f} ms "
              f"({dp_cost / max(best_cost, 1e-12):.2f}x)")
    errs = strategy.validate()
    if errs:
        raise RuntimeError(f"search produced an unsound strategy: "
                           f"{errs}")
    if cfg.export_strategy_file:
        save_strategy(cfg.export_strategy_file, strategy, best,
                      {"best_cost": best_cost, "dp_cost": dp_cost})
    phases["mcmc_s"] = round(time.perf_counter() - t0, 3)
    return _apply_floor_guard(ff, (strategy, None))


def _write_unity_audit(ff, cost_model, graph, gc, info):
    """Strategy audit record (obs/audit.py): per-op predicted cost
    breakdown of the adopted PCG vs the canonical DP baseline, both
    priced by the additive evaluator so the per-op entries sum exactly
    to each side's recorded total. Written only when tracing is on
    (``FF_TRACE`` / ``FFConfig.trace``)."""
    if not obs_events.enabled():
        return
    from .unity import GraphCostEvaluator, data_parallel_graph
    dmesh = ff.dmesh
    inputs = ff.graph_inputs + getattr(ff, "const_inputs", [])
    ev = GraphCostEvaluator(cost_model, dmesh)
    with obs_events.span("search.audit"):
        a_gc, a_entries = ev.graph_cost_breakdown(graph)
        dp_g = data_parallel_graph(ff.layers, inputs,
                                   [ff._output_tensor], dmesh)
        d_gc, d_entries = ev.graph_cost_breakdown(dp_g)
    key = obs_audit.workload_key(ff.layers, dmesh.num_devices)
    record = {
        "search_algo": "unity",
        "ranker": getattr(info, "final_ranker", "additive"),
        "ranker_total_s": gc.total,
        "n_devices": dmesh.num_devices,
        "adopted": obs_audit.side_record(a_entries, a_gc.total),
        "dp_baseline": obs_audit.side_record(d_entries, d_gc.total),
        "predicted_dp_over_searched":
            d_gc.total / max(a_gc.total, 1e-12),
    }
    path = obs_audit.write_strategy_audit(record, key)
    if path:
        ff._strategy_audit_path = path
        obs_events.counter("search.audit_records")


def _write_mcmc_audit(ff, sim, best, dp):
    """MCMC-path strategy audit record: per-op breakdown of the best
    assignment vs the DP assignment from the same simulator."""
    if not obs_events.enabled():
        return
    with obs_events.span("search.audit"):
        b_gc, b_entries = sim.evaluate_breakdown(best)
        d_gc, d_entries = sim.evaluate_breakdown(dp)
    key = obs_audit.workload_key(ff.layers, ff.dmesh.num_devices)
    # side totals are the pre-penalty component sums, so per_op entries
    # always sum to them; ranker_total_s keeps the simulator's (possibly
    # memory-penalized) objective
    b_tot = b_gc.compute + b_gc.xfer + b_gc.sync
    d_tot = d_gc.compute + d_gc.xfer + d_gc.sync
    record = {
        "search_algo": "mcmc",
        "ranker": "additive",
        "ranker_total_s": b_gc.total,
        "n_devices": ff.dmesh.num_devices,
        "adopted": obs_audit.side_record(b_entries, b_tot),
        "dp_baseline": obs_audit.side_record(d_entries, d_tot),
        "predicted_dp_over_searched": d_tot / max(b_tot, 1e-12),
    }
    path = obs_audit.write_strategy_audit(record, key)
    if path:
        ff._strategy_audit_path = path
        obs_events.counter("search.audit_records")


def _synth_batch(ff):
    """Random batch matching the graph inputs + label, on the model's
    device. Int tensors get tiny non-negative ids (valid for any
    embedding), labels get class 0 (valid for any loss); values only
    need to execute, not converge."""
    import numpy as np
    import torch

    from ..ffconst import DataType, LossType
    rng = np.random.default_rng(ff.config.seed)
    batch = {}
    for t in ff.graph_inputs:
        if t.dtype in (DataType.DT_INT32, DataType.DT_INT64):
            batch[t.name] = rng.integers(0, 2, size=t.shape).astype(np.int32)
        elif t.dtype == DataType.DT_BOOLEAN:
            batch[t.name] = np.ones(t.shape, dtype=bool)
        else:
            batch[t.name] = rng.normal(size=t.shape).astype(np.float32)
    lt = getattr(ff, "label_tensor", None)
    if lt is not None:
        if lt.dtype in (DataType.DT_INT32, DataType.DT_INT64):
            batch["label"] = np.zeros(lt.shape, dtype=np.int32)
        else:
            batch["label"] = np.zeros(lt.shape, dtype=np.float32)
    else:
        # no explicit label tensor: derive from the output + loss type
        # (same contract the loss fn applies at step time)
        oshape = ff._output_tensor.shape
        if ff.loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
            batch["label"] = np.zeros(oshape[:-1] + (1,), dtype=np.int32)
        else:
            batch["label"] = np.zeros(oshape, dtype=np.float32)
    return {k: torch.from_numpy(v).to(ff.device) for k, v in batch.items()}


def _timed_steps(carry, times, extra):
    """Run ``extra`` more synced train steps on a guard executor,
    appending each one's wall time (host clock up to the loss's read
    back, which waits for the card) to ``times``. ``carry`` holds
    ``[step, params, opt_state, state, batch]`` and is updated."""
    step, p, o, s, batch = carry
    base = len(times)
    for i in range(extra):
        t0 = time.perf_counter()
        p, o, s, bm = step(p, o, s, base + i + 1, batch)
        float(bm["loss"])
        times.append(time.perf_counter() - t0)
    carry[1:4] = [p, o, s]
    return times


def _time_strategy(ff, strategy, info):
    """Build + time ``floor_guard_steps`` train steps of one strategy's
    program on the model's device. Returns (mean seconds/step, executor,
    per_step_times, carry): FFModel.compile adopts the winning
    executor; times + carry let the guard extend the measurement via
    :func:`_timed_steps` when the decision is within timing noise."""
    from ..executor import Executor, GraphProgram
    cfg = ff.config
    steps = max(1, cfg.floor_guard_steps)
    layers, outputs = ff.layers, [ff._output_tensor]
    if info is not None:
        layers, outputs = info.layers, info.output_tensors
    program = GraphProgram(
        layers, ff.graph_inputs + getattr(ff, "const_inputs", []), outputs)
    ex = Executor(program, cfg, ff.device, ff.optimizer, ff.loss_type,
                  getattr(ff, "metrics", []), seed=cfg.seed)
    program.stage_consts(ff.device)
    params, state = ex.init_params_and_state()
    opt_state = ff.optimizer.init_state(params)
    batch = _synth_batch(ff)
    step = ex.make_train_step()
    p, o, s, bm = step(params, opt_state, state, 0, batch)
    float(bm["loss"])  # warm-up + sync
    carry = [step, p, o, s, batch]
    times = _timed_steps(carry, [], steps)
    return sum(times) / len(times), ex, times, carry


def _mean_std(times):
    n = len(times)
    m = sum(times) / n
    var = sum((t - m) ** 2 for t in times) / (n - 1) if n > 1 else 0.0
    return m, var ** 0.5


def _apply_floor_guard(ff, result):
    """Measured DP floor on search adoption: time a few real steps of the
    searched program AND plain data parallel on the card; keep DP when
    the searched program measures slower. Records both numbers in
    ``ff._floor_guard_record`` and in the strategy export. ``auto`` runs
    it on the card only (as the JAX package does on a chip); a
    described mesh has nothing to time it on."""
    cfg = ff.config
    mode = _on(cfg.search_floor_guard)
    if mode in ("false", "off", "0", "no") or ff.dmesh.described:
        return result
    if mode == "auto" and ff.device.type != "cuda":
        return result  # the CPU: the double build costs too much
    strategy, info = result
    dp = ShardingStrategy.data_parallel(ff.layers, ff.graph_inputs,
                                        ff.dmesh)
    guard_t0 = time.perf_counter()
    t_s, ex_s, times_s, carry_s = _time_strategy(ff, strategy, info)
    t_dp, ex_dp, times_dp, carry_dp = _time_strategy(ff, dp, None)
    # when the margin between the two means is inside the combined
    # timing noise (2 x standard error), keep measuring — up to 4x the
    # base step count — instead of deciding from ~3 noisy steps
    max_steps = max(2, len(times_s), 4 * max(1, cfg.floor_guard_steps))
    while len(times_s) < max_steps:
        m_s, sd_s = _mean_std(times_s)
        m_dp, sd_dp = _mean_std(times_dp)
        sem = 2.0 * (sd_s ** 2 / len(times_s)
                     + sd_dp ** 2 / len(times_dp)) ** 0.5
        if len(times_s) >= 2 and (abs(m_s - m_dp) > sem
                                  or (sd_s == 0.0 and sd_dp == 0.0)):
            break
        extra = min(len(times_s), max_steps - len(times_s))
        _timed_steps(carry_s, times_s, extra)
        _timed_steps(carry_dp, times_dp, extra)
    t_s, sd_s = _mean_std(times_s)
    t_dp, sd_dp = _mean_std(times_dp)
    adopted = "searched" if t_s <= t_dp else "dp"
    record = {"searched_s_per_step": t_s, "dp_s_per_step": t_dp,
              "searched_std": sd_s, "dp_std": sd_dp,
              "n_steps": len(times_s), "adopted": adopted}
    ff._floor_guard_record = record
    guard_s = time.perf_counter() - guard_t0
    ff.__dict__.setdefault("_compile_phases", {})["floor_guard_s"] = \
        round(guard_s, 3)
    obs_events.record_span("search.floor_guard", guard_t0, guard_s,
                           adopted=adopted)
    audit_path = getattr(ff, "_strategy_audit_path", None)
    if audit_path:
        obs_audit.annotate_strategy_audit(audit_path,
                                          {"floor_guard": record})
    # hand the winning side's executor to FFModel.compile (params are
    # re-initialized there: the guard's synthetic steps must not leak
    # into training)
    ff._prebuilt_executor = (strategy, ex_s) if adopted == "searched" \
        else (dp, ex_dp)
    del carry_s, carry_dp
    if adopted == "dp":
        logging.getLogger("flexflow_tpu_torch").warning(
            "searched strategy measured %.2f ms/step vs data-parallel "
            "%.2f ms/step — keeping data parallel (measured DP floor)",
            t_s * 1e3, t_dp * 1e3)
        if cfg.export_strategy_file:
            # the export must describe the ADOPTED strategy
            save_strategy(cfg.export_strategy_file, dp, None,
                          {"floor_guard": record})
        return dp, None
    if cfg.export_strategy_file:
        _annotate_export(cfg.export_strategy_file, {"floor_guard": record})
    if cfg.profiling:
        print(f"floor guard: searched {t_s * 1e3:.2f} ms/step <= DP "
              f"{t_dp * 1e3:.2f} ms/step — adopting searched")
    return result


def _annotate_export(path: str, extra) -> None:
    """Merge ``extra`` into an exported strategy file (written by this
    search moments before)."""
    with open(path) as f:
        doc = json.load(f)
    doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def _unity(ff, cost_model: OpCostModel, t0: float):
    """Unity substitution-DP search path (default)."""
    from .unity import unity_search
    cfg = ff.config
    dmesh = ff.dmesh
    budget = cfg.search_budget if cfg.search_budget > 0 else 32
    mem_budget = None
    if cfg.enable_memory_search:
        mem_budget = (cfg.device_mem_mb * (1 << 20)
                      if cfg.device_mem_mb > 0 else dmesh.spec.hbm_bytes)
    xfers = None
    if cfg.substitution_json_path:
        # reference-format rule collection (graph_subst_3_v2.json schema)
        # appended to the programmatic parallelization xfers
        from .substitution import generate_all_pcg_xfers
        from .substitution_loader import load_rule_collection
        degrees = [d for d in dmesh.valid_degrees() if d > 1]
        xfers = list(generate_all_pcg_xfers(degrees))
        xfers += load_rule_collection(cfg.substitution_json_path)
    inputs = ff.graph_inputs + getattr(ff, "const_inputs", [])
    with obs_events.span("search.unity", budget=budget):
        info, strategy, gc, graph = unity_search(
            ff.layers, inputs, [ff._output_tensor], dmesh, cost_model,
            budget=budget, alpha=max(cfg.search_alpha, 1.0 + 1e-6),
            mem_budget_bytes=mem_budget,
            base_optimize_threshold=max(cfg.base_optimize_threshold, 2),
            xfers=xfers)
    _write_unity_audit(ff, cost_model, graph, gc, info)
    # the adopted PCG, retained for post-compile analysis
    ff._adopted_pcg = graph
    # predicted searched-vs-DP costs, recorded so the searched step's
    # prediction can be held against its measurement
    dp_pred = getattr(info, "dp_predicted_total", None)
    if dp_pred is None:
        from .unity import GraphCostEvaluator, data_parallel_graph
        dp_pred = GraphCostEvaluator(cost_model, dmesh).graph_cost(
            data_parallel_graph(ff.layers, inputs, [ff._output_tensor],
                                dmesh)).total
    ff._search_predicted = {"searched_cost_s": gc.total,
                            "dp_cost_s": dp_pred,
                            "peak_mem_per_dev_bytes": gc.peak_memory
                            / max(dmesh.num_devices, 1)}
    if cfg.profiling:
        print(f"unity search: {time.perf_counter() - t0:.2f}s, "
              f"cost {gc.total * 1e3:.3f} ms "
              f"(compute {gc.compute * 1e3:.3f} xfer {gc.xfer * 1e3:.3f} "
              f"sync {gc.sync * 1e3:.3f})")
    if cfg.export_strategy_task_graph_file:
        with open(cfg.export_strategy_task_graph_file, "w") as f:
            f.write(graph.to_dot())
    if cfg.export_strategy_file:
        from .serialization import program_to_json
        prog_doc = program_to_json(info.layers, inputs,
                                   info.output_tensors[0])
        save_strategy(cfg.export_strategy_file, strategy, None,
                      {"best_cost": gc.total}, program=prog_doc)
    return strategy, info


def _import_strategy(ff, path: str, dmesh):
    """--import: load a saved strategy; when it carries a serialized
    rewritten program (Unity export), rebuild that program too so
    parallel ops and layer names line up with the saved shardings."""
    from ..pcg.graph import GraphProgramInfo
    from .serialization import program_from_json
    strategy = load_strategy(path, ff.layers, dmesh)
    with open(path) as f:
        doc = json.load(f)
    prog_doc = doc.get("program")
    if not prog_doc:
        return strategy, None
    layers, out_t = program_from_json(
        prog_doc, ff.graph_inputs + getattr(ff, "const_inputs", []))
    return strategy, GraphProgramInfo(layers, {}, [out_t])
