"""Runtime configuration and flag system.

The port's copy of ``flexflow_tpu/config.py``: the same fields, defaults
and flag spellings, so a launch script written for the JAX package parses
unchanged. The serving slice reads ``batch_size``, ``only_data_parallel``,
``use_bf16_compute``, ``allow_tensor_op_math_conversion``,
``bf16_activations``, ``use_flash_attention``, ``kernel_impls`` and
``seed``; the serving search reads ``serving_buckets``,
``serving_max_seq`` and ``serving_decode_tokens``
(``search/serving_plan.py``), the repository's loaders
``serving_floor_guard`` (``serving/session.py``); the other fields are
accepted and kept for the later slices that port the features they
configure (pipelines, ZeRO, overlap, quantized collectives).

One addition: ``device`` ("cuda" unless ``--device cpu``) names where
``FFModel`` places parameters and runs.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional, Sequence


def default_cache_dir() -> str:
    """Where the port keeps its op measurements, calibration table and
    strategy audits: ``FF_CACHE_DIR`` when set, else
    ``<repo>/.ffcache/torch`` (its own directory: the JAX package's
    files are under ``.ffcache/``)."""
    return os.environ.get("FF_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".ffcache", "torch")


@dataclasses.dataclass
class FFConfig:
    # -------- training --------
    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    weight_decay: float = 1e-4
    print_freq: int = 10
    dataset_path: str = ""
    # -------- machine --------
    num_nodes: int = 1
    workers_per_node: int = 0
    cpus_per_node: int = 1
    coordinator_address: str = ""
    process_id: int = -1
    heartbeat_interval_s: float = 0.0
    heartbeat_timeout_s: float = 0.0
    barrier_timeout_s: float = 0.0
    device_mem_mb: int = 0
    # where parameters live and the forward runs: "cuda" (the default)
    # or "cpu"; an unavailable CUDA device is an error, never a fallback
    device: str = "cuda"
    # -------- search --------
    search_budget: int = -1
    search_alpha: float = 1.2
    only_data_parallel: bool = False
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_sample_parallel: bool = False
    enable_propagation: bool = False
    enable_inplace_optimizations: bool = False
    search_overlap_backward_update: bool = False
    search_num_nodes: int = -1
    search_num_workers: int = -1
    base_optimize_threshold: int = 10
    enable_memory_search: bool = False
    search_algo: str = "unity"
    substitution_json_path: Optional[str] = None
    # -------- simulator --------
    simulator_workspace_mb: int = 2048
    machine_model_version: int = 0
    machine_model_file: str = ""
    simulator_segment_size: int = 16777216
    simulator_max_num_segments: int = 1
    calibration_v2: str = "auto"
    hier_placement: str = "auto"
    # -------- observability --------
    trace: str = "auto"
    trace_export_file: str = ""
    attribution: str = "auto"
    attribution_steps: int = 3
    # -------- execution --------
    perform_fusion: bool = False
    allow_tensor_op_math_conversion: bool = True
    computation_mode: str = "training"
    profiling: bool = False
    plan_verify: bool = True
    # -------- strategy import/export --------
    export_strategy_file: str = ""
    import_strategy_file: str = ""
    export_strategy_task_graph_file: str = ""
    export_strategy_computation_graph_file: str = ""
    include_costs_dot_graph: bool = False
    # -------- parallelism --------
    mesh_shape: Optional[Sequence[int]] = None
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    pipeline_chunks: int = 1
    pipeline_tp: int = 1
    tensor_parallel: int = 1
    sequence_parallel: bool = False
    shard_optimizer_states: bool = False
    zero_policy: str = "off"
    zero_overhead_frac: float = 0.05
    overlap: str = "auto"
    overlap_bucket_mb: float = 4.0
    zero_prefetch: int = 1
    quantized_collectives: str = "off"
    qsync_wire: str = "int8"
    remat: str = "none"
    gradient_accumulation_steps: int = 1
    enable_pipeline_search: bool = False
    pipeline_ragged: str = "auto"
    banked_placement: str = "auto"
    # matmul operands in bf16 with f32 results (ops/registry.py matmul)
    use_bf16_compute: bool = True
    # inter-op activations stored in bf16 (weights stay f32)
    bf16_activations: bool = False
    async_dispatch_steps: int = 8
    prefetch_batches: int = 2
    compilation_cache_dir: str = ""
    # deprecated tri-state, a shim over kernel_impls (kernels/registry.py
    # resolve_forced warns on "true"/"false")
    use_flash_attention: str = "auto"
    # "<op>:<impl>[,...]" forces kernel impls, e.g. "attention:flash";
    # FF_KERNEL_IMPL and --kernel-impl override
    kernel_impls: str = "auto"
    seq_parallel_degree: int = 0
    search_floor_guard: str = "auto"
    floor_guard_steps: int = 3
    # -------- serving plans --------
    serving_buckets: str = ""
    serving_max_seq: int = 0
    serving_decode_tokens: int = 0
    serving_strategy_file: str = ""
    serving_floor_guard: str = "auto"
    seed: int = 0

    def serving_buckets_list(self) -> List[int]:
        """Parsed ``serving_buckets`` ([] = caller defaults); read by the
        serving search (``search/serving_plan.py``)."""
        if not self.serving_buckets:
            return []
        return sorted({int(b) for b in
                       str(self.serving_buckets).split(",") if b})

    @classmethod
    def parse_args(cls, argv: Optional[List[str]] = None) -> "FFConfig":
        """Parse the JAX package's command-line flags (same spellings).
        Unknown flags are skipped, as there."""
        cfg = cls()
        args = list(sys.argv[1:] if argv is None else argv)
        i = 0

        def take() -> str:
            nonlocal i
            i += 1
            return args[i]

        while i < len(args):
            a = args[i]
            if a in ("-e", "--epochs"):
                cfg.epochs = int(take())
            elif a in ("-b", "--batch-size"):
                cfg.batch_size = int(take())
            elif a in ("--lr", "--learning-rate"):
                cfg.learning_rate = float(take())
            elif a in ("--wd", "--weight-decay"):
                cfg.weight_decay = float(take())
            elif a in ("-p", "--print-freq"):
                cfg.print_freq = int(take())
            elif a in ("-d", "--dataset"):
                cfg.dataset_path = take()
            elif a == "--device":
                cfg.device = take()
            elif a in ("--budget", "--search-budget"):
                cfg.search_budget = int(take())
            elif a in ("--alpha", "--search-alpha"):
                cfg.search_alpha = float(take())
            elif a == "--only-data-parallel":
                cfg.only_data_parallel = True
            elif a == "--no-plan-verify":
                cfg.plan_verify = False
            elif a == "--enable-parameter-parallel":
                cfg.enable_parameter_parallel = True
            elif a == "--enable-attribute-parallel":
                cfg.enable_attribute_parallel = True
            elif a == "--enable-sample-parallel":
                cfg.enable_sample_parallel = True
            elif a == "--enable-propagation":
                cfg.enable_propagation = True
            elif a == "--enable-inplace-optimizations":
                cfg.enable_inplace_optimizations = True
            elif a == "--overlap":
                cfg.search_overlap_backward_update = True
            elif a == "--search-num-nodes":
                cfg.search_num_nodes = int(take())
            elif a == "--search-num-workers":
                cfg.search_num_workers = int(take())
            elif a == "--base-optimize-threshold":
                cfg.base_optimize_threshold = int(take())
            elif a == "--memory-search":
                cfg.enable_memory_search = True
            elif a == "--search-algo":
                cfg.search_algo = take()
            elif a == "--substitution-json":
                cfg.substitution_json_path = take()
            elif a == "--floor-guard":
                cfg.search_floor_guard = take().lower()
            elif a == "--no-floor-guard":
                cfg.search_floor_guard = "false"
            elif a == "--simulator-workspace-size":
                cfg.simulator_workspace_mb = int(take())
            elif a == "--machine-model-version":
                cfg.machine_model_version = int(take())
            elif a == "--machine-model-file":
                cfg.machine_model_file = take()
            elif a == "--simulator-segment-size":
                cfg.simulator_segment_size = int(take())
            elif a == "--simulator-max-num-segments":
                cfg.simulator_max_num_segments = int(take())
            elif a == "--calibration-v2":
                cfg.calibration_v2 = take().lower()
            elif a == "--hier-placement":
                cfg.hier_placement = take().lower()
            elif a == "--no-hier-placement":
                cfg.hier_placement = "false"
            elif a == "--trace":
                cfg.trace = "true"
            elif a == "--no-trace":
                cfg.trace = "false"
            elif a == "--trace-export":
                cfg.trace_export_file = take()
                cfg.trace = "true"
            elif a == "--attribution":
                cfg.attribution = "true"
            elif a == "--no-attribution":
                cfg.attribution = "false"
            elif a == "--attribution-steps":
                cfg.attribution_steps = int(take())
            elif a == "--fusion":
                cfg.perform_fusion = True
            elif a == "--profiling":
                cfg.profiling = True
            elif a == "--allow-tensor-op-math-conversion":
                cfg.allow_tensor_op_math_conversion = True
                cfg.use_bf16_compute = True
            elif a in ("--no-tensor-op-math-conversion", "--f32-compute"):
                cfg.allow_tensor_op_math_conversion = False
                cfg.use_bf16_compute = False
            elif a in ("--export", "--export-strategy"):
                cfg.export_strategy_file = take()
            elif a in ("--import", "--import-strategy"):
                cfg.import_strategy_file = take()
            elif a == "--taskgraph":
                cfg.export_strategy_task_graph_file = take()
            elif a == "--compgraph":
                cfg.export_strategy_computation_graph_file = take()
            elif a == "--include-costs-dot-graph":
                cfg.include_costs_dot_graph = True
            elif a in ("-ll:tpu", "-ll:gpu"):
                cfg.workers_per_node = int(take())
            elif a == "-ll:cpu":
                cfg.cpus_per_node = int(take())
            elif a == "-ll:fsize":
                cfg.device_mem_mb = int(take())
            elif a == "--nodes":
                cfg.num_nodes = int(take())
            elif a == "--coordinator-address":
                cfg.coordinator_address = take()
            elif a == "--process-id":
                cfg.process_id = int(take())
            elif a == "--mesh-shape":
                cfg.mesh_shape = tuple(int(x) for x in take().split("x"))
            elif a in ("--pp", "--pipeline-stages"):
                cfg.pipeline_stages = int(take())
            elif a in ("--num-microbatches", "--pipeline-microbatches"):
                cfg.pipeline_microbatches = int(take())
            elif a in ("--pipeline-chunks", "--interleave"):
                cfg.pipeline_chunks = int(take())
            elif a in ("--pp-tp", "--pipeline-tp"):
                cfg.pipeline_tp = int(take())
            elif a in ("--tp", "--tensor-parallel"):
                cfg.tensor_parallel = int(take())
            elif a in ("--sp", "--sequence-parallel"):
                cfg.sequence_parallel = True
            elif a == "--seq-parallel":
                cfg.seq_parallel_degree = int(take())
            elif a == "--kernel-impl":
                # repeated flags accumulate
                v = take()
                cfg.kernel_impls = v if cfg.kernel_impls == "auto" \
                    else f"{cfg.kernel_impls},{v}"
            elif a == "--bf16-activations":
                cfg.bf16_activations = True
            elif a in ("--zero", "--shard-optimizer-states"):
                cfg.shard_optimizer_states = True
            elif a == "--zero-policy":
                cfg.zero_policy = take().lower()
            elif a == "--zero-search":
                cfg.zero_policy = "auto"
            elif a == "--zero-overhead-frac":
                cfg.zero_overhead_frac = float(take())
            elif a == "--overlap-schedule":
                cfg.overlap = take().lower()
            elif a == "--no-overlap-schedule":
                cfg.overlap = "off"
            elif a == "--overlap-bucket-mb":
                cfg.overlap_bucket_mb = float(take())
            elif a == "--zero-prefetch":
                cfg.zero_prefetch = int(take())
            elif a == "--quantized-collectives":
                cfg.quantized_collectives = take().lower()
            elif a == "--no-quantized-collectives":
                cfg.quantized_collectives = "disable"
            elif a == "--qsync-wire":
                cfg.qsync_wire = take().lower()
            elif a == "--remat":
                cfg.remat = "blocks"
            elif a in ("--gradient-accumulation-steps", "--accum"):
                cfg.gradient_accumulation_steps = int(take())
            elif a == "--enable-pipeline-search":
                cfg.enable_pipeline_search = True
            elif a == "--banked-placement":
                cfg.banked_placement = take()
            elif a == "--pipeline-ragged":
                cfg.pipeline_ragged = take()
            elif a == "--async-dispatch-steps":
                cfg.async_dispatch_steps = int(take())
            elif a == "--sync-every-step":
                cfg.async_dispatch_steps = 0
            elif a == "--prefetch-batches":
                cfg.prefetch_batches = int(take())
            elif a == "--serving-buckets":
                cfg.serving_buckets = take()
            elif a == "--serving-max-seq":
                cfg.serving_max_seq = int(take())
            elif a == "--serving-decode-tokens":
                cfg.serving_decode_tokens = int(take())
            elif a == "--serving-strategy":
                cfg.serving_strategy_file = take()
            elif a == "--serving-floor-guard":
                cfg.serving_floor_guard = take()
            elif a == "--compilation-cache-dir":
                cfg.compilation_cache_dir = take()
            elif a == "--seed":
                cfg.seed = int(take())
            i += 1
        return cfg
