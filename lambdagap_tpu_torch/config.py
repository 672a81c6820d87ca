"""Configuration for lambdagap_tpu_torch.

A copy of ``lambdagap_tpu/config.py`` (the port imports nothing of the JAX
package): the analog of the reference's single annotated ``Config`` struct
(reference: include/LightGBM/config.h:104-1348) plus alias resolution
(``Config::KV2Map``/``Config::Set``, src/io/config.cpp:512 and the generated
alias table in src/io/config_auto.cpp). One dataclass is the single source of
truth for parameter names, defaults, and validation.

Fork-specific parameters (the LambdaGap delta): ``lambdarank_target`` with 18
selectable gradient targets and ``lambdagap_weight``
(reference: include/LightGBM/config.h:989-1013).

The port's defaults differ from the JAX package's in two places:
``device_type`` is ``"cuda"`` (entry points run on the card unless the
caller asks for ``"cpu"``), and ``predict_engine`` is ``"compiled"`` (the
hand-written traversal kernel; ``"tensor"`` and ``"scan"`` run the same
scores in plain torch ops).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .utils import log

# int8 quantized-gradient level cap (a copy of
# lambdagap_tpu/ops/hist_pallas.py MAX_QUANT_BINS)
MAX_QUANT_BINS = 127
DEVICE_TYPES = ("cuda", "cpu")

# ---------------------------------------------------------------------------
# Alias table (reference: src/io/config_auto.cpp alias map; kept by hand here,
# names and semantics match the reference docs)
# ---------------------------------------------------------------------------
_ALIASES: Dict[str, str] = {}


def _alias(canonical: str, *names: str) -> None:
    for n in names:
        _ALIASES[n] = canonical


_alias("config", "config_file")
_alias("task", "task_type")
_alias("objective", "objective_type", "app", "application", "loss")
_alias("boosting", "boosting_type", "boost")
_alias("data_sample_strategy", "sample_strategy")
_alias("data", "train", "train_data", "train_data_file", "data_filename")
_alias("valid", "test", "valid_data", "valid_data_file", "test_data",
       "test_data_file", "valid_filenames")
_alias("num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
       "num_round", "num_rounds", "nrounds", "num_boost_round", "n_estimators",
       "max_iter")
_alias("learning_rate", "shrinkage_rate", "eta")
_alias("num_leaves", "num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes")
_alias("tree_learner", "tree", "tree_type", "tree_learner_type")
_alias("num_threads", "num_thread", "nthread", "nthreads", "n_jobs")
_alias("device_type", "device")
_alias("seed", "random_seed", "random_state")
_alias("min_data_in_leaf", "min_data_per_leaf", "min_data", "min_child_samples",
       "min_samples_leaf")
_alias("min_sum_hessian_in_leaf", "min_sum_hessian_per_leaf", "min_sum_hessian",
       "min_hessian", "min_child_weight")
_alias("bagging_fraction", "sub_row", "subsample", "bagging")
_alias("pos_bagging_fraction", "pos_sub_row", "pos_subsample", "pos_bagging")
_alias("neg_bagging_fraction", "neg_sub_row", "neg_subsample", "neg_bagging")
_alias("bagging_freq", "subsample_freq")
_alias("bagging_seed", "bagging_fraction_seed")
_alias("feature_fraction", "sub_feature", "colsample_bytree")
_alias("feature_fraction_bynode", "sub_feature_bynode", "colsample_bynode")
_alias("feature_fraction_seed", "feature_fraction_random_seed")
_alias("extra_trees", "extra_tree")
_alias("early_stopping_round", "early_stopping_rounds", "early_stopping",
       "n_iter_no_change")
_alias("max_delta_step", "max_tree_output", "max_leaf_output")
_alias("lambda_l1", "reg_alpha", "l1_regularization")
_alias("lambda_l2", "reg_lambda", "lambda", "l2_regularization")
_alias("linear_lambda", "linear_tree_regularization")
_alias("min_gain_to_split", "min_split_gain")
_alias("drop_rate", "rate_drop")
_alias("max_drop", "max_drops")
_alias("uniform_drop", "uniform_drops")
_alias("top_rate", "goss_top_rate")
_alias("other_rate", "goss_other_rate")
_alias("min_data_per_group", "min_data_per_categorical_group")
_alias("cat_smooth", "categorical_smooth", "cat_smooth_ratio")
_alias("cat_l2", "categorical_l2")
_alias("max_cat_threshold", "max_categorical_threshold")
_alias("max_cat_to_onehot", "max_categorical_to_onehot")
_alias("top_k", "topk")
_alias("monotone_constraints", "mc", "monotone_constraint", "monotonic_cst")
_alias("monotone_constraints_method", "monotone_constraining_method", "mc_method")
_alias("monotone_penalty", "monotone_splits_penalty", "ms_penalty", "mc_penalty")
_alias("feature_contri", "feature_contrib", "fc", "fp", "feature_penalty")
_alias("forcedsplits_filename", "fs", "forced_splits_filename", "forced_splits_file",
       "forced_splits")
_alias("refit_decay_rate", "refit_decay")
_alias("path_smooth", "path_smoothing")
_alias("interaction_constraints", "interaction_constraints_vector")
_alias("verbosity", "verbose")
_alias("input_model", "model_input", "model_in")
_alias("output_model", "model_output", "model_out")
_alias("saved_feature_importance_type", "save_feature_importance_type")
_alias("snapshot_freq", "save_period")
_alias("machine_rank", "process_id", "rank")
_alias("max_bin", "max_bins")
_alias("min_data_in_bin", "min_data_per_bin")
_alias("bin_construct_sample_cnt", "subsample_for_bin")
_alias("data_random_seed", "data_seed")
_alias("is_enable_sparse", "is_sparse", "enable_sparse", "sparse")
_alias("enable_bundle", "is_enable_bundle", "bundle")
_alias("use_missing", "use_missing_values")
_alias("zero_as_missing", "zero_as_missing_value")
_alias("two_round", "two_round_loading", "use_two_round_loading")
_alias("header", "has_header")
_alias("label_column", "label")
_alias("weight_column", "weight")
_alias("group_column", "group", "group_id", "query_column", "query", "query_id")
_alias("ignore_column", "ignore_feature", "blacklist")
_alias("categorical_feature", "cat_feature", "categorical_column", "cat_column",
       "categorical_features")
_alias("forcedbins_filename", "forced_bins_filename", "forced_bins_file")
_alias("save_binary", "is_save_binary", "is_save_binary_file")
_alias("precise_float_parser", "use_precise_float_parser")
_alias("start_iteration_predict", "predict_start_iteration")
_alias("num_iteration_predict", "predict_num_iteration")
_alias("predict_raw_score", "is_predict_raw_score", "raw_score")
_alias("predict_leaf_index", "is_predict_leaf_index", "leaf_index")
_alias("predict_contrib", "is_predict_contrib", "contrib")
_alias("convert_model_language", "convert_model_lang")
_alias("convert_model", "convert_model_file")
_alias("num_class", "num_classes")
_alias("is_unbalance", "unbalance", "unbalanced_sets")
_alias("scale_pos_weight", "scale_pos_weight_ratio")
_alias("sigmoid", "sigmoid_param")
_alias("boost_from_average", "boost_from_mean")
_alias("alpha", "quantile_alpha")
_alias("fair_c", "fair_constant")
_alias("poisson_max_delta_step", "poisson_max_delta")
_alias("tweedie_variance_power", "tweedie_power")
_alias("lambdarank_truncation_level", "lambdarank_truncation")
_alias("metric", "metrics", "metric_types")
_alias("metric_freq", "output_freq")
_alias("is_provide_training_metric", "training_metric", "is_training_metric",
       "train_metric")
_alias("eval_at", "ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")
_alias("num_machines", "num_machine")
_alias("local_listen_port", "local_port", "port")
_alias("time_out", "network_timeout")
_alias("machine_list_filename", "machine_list_file", "machine_list", "mlist")
_alias("machines", "workers", "nodes")
_alias("gpu_device_id", "device_id")
_alias("num_gpu", "num_gpus")
_alias("serve_buckets", "serve_padding_buckets")
_alias("serve_max_delay_ms", "serve_max_latency_ms")
_alias("telemetry", "timetag", "enable_telemetry")
_alias("telemetry_out", "telemetry_file", "run_log")

# Fork delta aliases (none published; canonical names only)

# ---------------------------------------------------------------------------
# Knobs accepted for reference compatibility but deliberately inert in the
# JAX package: they parse, validate, alias-resolve, and round-trip through
# model files, but no module reads them at runtime (row/col-wise forcing,
# histogram pooling, OpenMP threading, sparse toggles, and the GPU device
# selection block). Kept as the JAX package declares them; which of them
# gain a meaning on the card is decided slice by slice (ROADMAP.md).
# ---------------------------------------------------------------------------
COMPAT_ACCEPTED = frozenset({
    "num_threads",            # OpenMP thread count; XLA manages threading
    "force_col_wise",         # row/col-wise histogram choice is layout-fixed here
    "force_row_wise",
    "histogram_pool_size",    # host histogram pool; histograms live in HBM
    "is_enable_sparse",       # sparse row format; the packed binned matrix is dense
    "feature_pre_filter",     # bin-time feature filtering not implemented
    "save_binary",            # reference binary dataset dump format
    "precise_float_parser",   # reference text parser option; numpy parses here
    "parser_config_file",
    "time_out",               # socket-cluster timeout; TPU meshes have no sockets
    "gpu_platform_id",        # GPU device selection block: no analog on TPU
    "gpu_device_id",
    "gpu_use_dp",
    "num_gpu",
})

_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1", "mae": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

LAMBDARANK_TARGETS = (
    "ranknet", "bin-ranknet", "ndcg", "bndcg",
    "lambdaloss-ndcg", "lambdaloss-bndcg",
    "lambdaloss-ndcg-plus-plus", "lambdaloss-bndcg-plus-plus",
    "precision", "arpk", "lambdaloss-arp1", "lambdaloss-arp2",
    "lambdagap-s", "lambdagap-x",
    "lambdagap-s-plus", "lambdagap-x-plus",
    "lambdagap-s-plus-plus", "lambdagap-x-plus-plus",
)


def _parse_list(val: Any, typ=float) -> List:
    if val is None:
        return []
    if isinstance(val, str):
        if not val.strip():
            return []
        return [typ(x) for x in val.replace(";", ",").split(",") if x.strip()]
    if isinstance(val, (list, tuple)):
        return [typ(x) for x in val]
    return [typ(val)]


def _parse_bool(val: Any) -> bool:
    if isinstance(val, bool):
        return val
    if isinstance(val, str):
        return val.strip().lower() in ("true", "1", "yes", "+", "on")
    return bool(val)


@dataclass
class Config:
    """Full training/prediction configuration.

    Field names, defaults and checks follow the reference's Config struct
    (include/LightGBM/config.h); only fields meaningful on TPU are kept live,
    the rest are accepted and preserved for compatibility.
    """

    # -- core -------------------------------------------------------------
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"                    # gbdt / dart / rf / goss(alias)
    data_sample_strategy: str = "bagging"     # bagging / goss
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"              # serial/feature/data/voting
    num_threads: int = 0
    device_type: str = "cuda"                 # cuda (the card) / cpu
    seed: int = 0
    deterministic: bool = False

    # -- learning control -------------------------------------------------
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    bagging_by_query: bool = False
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    early_stopping_min_delta: float = 0.0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    linear_lambda: float = 0.0           # ridge strength of the per-leaf linear solve (docs/linear-trees.md)
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: List[List[int]] = field(default_factory=list)
    verbosity: int = 1
    use_quantized_grad: bool = False
    num_grad_quant_bins: int = 4
    quant_train_renew_leaf: bool = False
    stochastic_rounding: bool = True

    # -- IO / dataset -----------------------------------------------------
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1
    linear_tree: bool = False            # piece-wise linear leaves: MXU-batched leaf solve, raw matrix retained (docs/linear-trees.md)
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: str = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False
    parser_config_file: str = ""

    # -- predict ----------------------------------------------------------
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    # device predict traversal engine: compiled = serving-shaped artifact
    # traversal (infer/ — quantized node blocks, pruned/merged trees, the
    # CUDA traversal kernel; raw rows only); tensor = batched [rows x trees]
    # traversal in torch ops (ops/predict_tensor.py); scan = sequential
    # per-tree reference oracle (bit-identical outputs)
    predict_engine: str = "compiled"     # compiled (infer artifact, CUDA traversal kernel) / tensor (batched torch ops) / scan (per-tree oracle)
    predict_tree_tile: int = 64          # trees per tensorized tile dispatch

    # -- infer (forest compiler; docs/serving.md "Compiled forest artifacts")
    infer_quant: str = "auto"            # threshold/bitset palette code width: auto / u8 / u16 (u8|u16 error instead of widening)
    infer_prune: bool = True             # drop branches no input can reach (exact path-interval analysis)
    infer_merge_trees: bool = True       # trees with identical pruned structure share one traversal
    infer_node_block_kb: int = 512       # node-table bytes per breadth-first block (the traversal kernel's VMEM working set)
    infer_row_block: int = 256           # kept for parity with the JAX package's config (its traversal kernel's rows per grid step); the port reads it nowhere: its kernels size their own tiles
    serve_pack_models: bool = False      # pack resident compiled models into ONE executable; mixed per-tenant batches dispatch once

    # -- serve (task=serve / Booster.as_server; docs/serving.md) ----------
    # padded request-batch sizes with pre-compiled predict executables;
    # arbitrary request sizes round up to the nearest bucket
    serve_buckets: List[int] = field(
        default_factory=lambda: [1, 8, 64, 512, 4096])
    serve_max_batch: int = 4096          # micro-batcher row cap per dispatch
    serve_max_delay_ms: float = 2.0      # coalescing window per batch
    serve_workers: int = 0               # parallel batch dispatchers; 0=auto
    serve_warmup: bool = True            # pre-compile buckets before serving
    serve_stats_file: str = ""           # task=serve: dump metrics JSON here
    serve_max_queue: int = 0             # bounded request queue (rows); 0 = unbounded
    serve_backpressure: str = "reject"   # full-queue policy: reject (ServeOverloaded) / block
    serve_timeout_ms: float = 0.0        # per-request deadline; expired requests are shed before dispatch; 0 = none
    serve_swap_breaker: int = 3          # consecutive swap failures opening the swap circuit; 0 = off
    serve_hbm_budget_mb: float = 0.0     # registry HBM byte budget for resident forests; LRU eviction above it; 0 = unlimited
    serve_models: str = ""               # extra registry models at startup: "name=path,name2=path2"
    serve_tenant_weights: str = ""       # weighted-fair dequeue: "tenant:weight,..."; unlisted tenants weigh 1
    serve_tenant_max_share: float = 0.0  # one tenant's max fraction of the bounded queue; 0 = off
    serve_port: int = -1                 # task=serve TCP frontend port: -1 = line loop, 0 = ephemeral, >0 = fixed
    serve_replicas: int = 1              # task=serve: replica servers behind the health-aware router
    serve_trace_sample: float = 0.0      # distributed-request-trace sample fraction [0, 1]; 0 = off
    serve_trace_out: str = ""            # span JSONL path (obs/events schema; per-record durability)
    serve_trace_ring: int = 4096         # recent spans/events kept per process for the flight recorder
    serve_flight_dump: str = ""          # flight-recorder dump path; armed on fault/SIGTERM when set
    serve_flight_interval_s: float = 0.0  # periodic flight dumps (SIGKILL durability); 0 = fault-only
    fleet_scrape_interval_s: float = 0.0  # router-side fleet scrape + signal-plane period; 0 = on demand
    fleet_scrape_timeout_s: float = 2.0  # per-replica stats RPC timeout during a scrape
    serve_autonomics: bool = False       # fleet control loop: revival + placement + delta rollout + autoscaling (off = byte-identical pre-autonomics behavior)
    serve_autonomics_interval_s: float = 1.0  # controller tick period
    serve_autonomics_revive_backoff_s: float = 0.5   # first revival retry delay (bounded exponential, deterministic jitter)
    serve_autonomics_revive_backoff_max_s: float = 30.0  # revival backoff hard cap
    serve_autonomics_probe_window: int = 3   # consecutive healthy ticks clearing a revived replica's probation
    serve_autonomics_scale_out_margin: float = 0.1   # scale OUT when knee_margin <= this (saturation approaching)
    serve_autonomics_scale_in_margin: float = 0.5    # scale IN when knee_margin >= this (demonstrated headroom)
    serve_autonomics_min_replicas: int = 1   # autoscaler floor (scale-in never goes below)
    serve_autonomics_max_replicas: int = 0   # autoscaler ceiling; 0 = autoscaling off (revival/placement still run)
    serve_autonomics_cooldown_s: float = 10.0  # minimum seconds between scale actions (rate limit)
    serve_autonomics_hysteresis_ticks: int = 3  # consecutive ticks a margin condition must hold before acting
    serve_autonomics_placement: bool = True  # HBM-aware model placement + residency-preferring routing (needs serve_hbm_budget_mb > 0 to bind)
    serve_shadow_sample: float = 0.0     # shadow-mirror sample fraction [0, 1]; mirrored requests re-score on the shadow replica strictly OFF the reply path; 0 = off (docs/continuous-learning.md)

    # -- continuous learning loop (lambdagap_tpu.loop; docs/continuous-learning.md)
    loop_shadow_min_requests: int = 200  # shadow comparisons required before the promote/reject decision
    loop_promote_threshold: float = 1e-3  # promote when the shadow window's mean |prediction delta| is <= this
    loop_interval_s: float = 1.0         # promotion-controller tick period / tailing-trainer poll period (seconds)
    loop_iters_per_fold: int = 5         # boosting iterations the tailing trainer adds per data fold (one candidate per fold)

    # -- guard (lambdagap_tpu.guard; docs/robustness.md) ------------------
    guard_nonfinite: str = "raise"       # non-finite grad/hess/score policy: raise / skip_tree / clip / off
    guard_clip: float = 1e30             # clip bound for guard_nonfinite=clip
    resume: str = ""                     # "auto" (continue from the latest valid training snapshot) is refused by name until the snapshots are ported
    guard_snapshot_keep: int = 0         # keep only the newest K snapshots, pruning after each write (the newest VALID one always survives); 0 = keep all
    guard_faults: str = ""               # fault-injection spec (testing; merges over LAMBDAGAP_FAULTS)

    # -- observability (lambdagap_tpu.obs; docs/observability.md) ---------
    telemetry: bool = False              # per-iteration phase spans + recompile watchdog
    telemetry_out: str = ""              # JSONL run-log path (implies telemetry=true)
    telemetry_ring: int = 256            # per-iteration records kept in memory
    telemetry_warmup: int = 2            # iterations before a recompile counts as steady-state
    profile_start_iter: int = -1         # jax.profiler window start iteration (-1 = off)
    profile_n_iters: int = 1             # profiler window length in iterations
    profile_dir: str = ""                # profiler trace output directory
    profile_serve_start_req: int = -1    # serve-side profiler window: submitted-request count to start at (-1 = off)
    profile_serve_n_req: int = 1         # serve-side profiler window length in requests
    profile_stream_start_window: int = -1  # predict_stream profiler window: window index to start at (-1 = off)
    profile_stream_n_windows: int = 1    # predict_stream profiler window length in windows
    cost_plane: bool = False             # analytic per-executable FLOP/byte/HBM ledger + roofline attribution (obs/costplane.py)
    cost_plane_out: str = ""             # COSTS.json ledger output path (implies cost_plane=true)
    cost_plane_memory: str = "compiled"  # peak-HBM source: compiled (XLA memory_analysis) / analytic (aval arithmetic; no extra backend compile)
    cost_plane_peaks: str = ""           # peak-table override "flops:bandwidth:hbm_bytes" (e.g. "197e12:819e9:17e9"); "" = per-device_kind table

    # -- convert ----------------------------------------------------------
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # -- objective --------------------------------------------------------
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    # Fork delta (include/LightGBM/config.h:989-1013): 18-way gradient target
    lambdarank_target: str = "ndcg"
    lambdagap_weight: float = 1.0
    label_gain: List[float] = field(default_factory=list)
    lambdarank_position_bias_regularization: float = 0.0

    # -- metric -----------------------------------------------------------
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # -- network (TPU: mesh axes instead of sockets) ----------------------
    num_machines: int = 1
    machine_rank: int = -1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # -- device -----------------------------------------------------------
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    num_gpu: int = 1

    # TPU-specific knobs (no reference analog; tuning surface for XLA/Pallas)
    tpu_rows_per_block: int = 4096           # kept for parity with the JAX package's config (its histogram tiles' rows); the port reads it nowhere: its kernels size their own tiles
    tpu_hist_impl: str = "auto"               # kept for parity with the JAX package's config; the port reads it nowhere: every histogram comes from ops/hist_cuda.hist_rows (the CUDA kernel on the card, its plain version on the CPU)
    # physical row layout during training, in both ported learners:
    #   gather — rows stay in dataset order; the histogram kernels read a
    #            leaf's rows through its slice of the leaf permutation, the
    #            partition a column-major copy
    #   sorted — leaf-ordered copies of the rows and their gradient
    #            channels, rebuilt each tree and moved with the
    #            permutation at each split, so the kernels read each leaf
    #            as a contiguous window; no column-major copy
    #   auto   — sorted at >= 2^20 rows, gather below, as the JAX package
    #            resolves it; the two grow the same trees bit for bit
    tree_layout: str = "auto"                 # auto / gather / sorted
    tpu_num_devices: int = 0                  # 0 = all visible devices
    mesh_shape: str = ""                      # device mesh extents "DATAxFEATURE" over parallel/sharding.py axes ("8", "8x1", "1x8", "4x2", wildcard "0x4"/"2x0" = all remaining devices on that axis); an explicit AxB grid routes distributed training through the fused 2-D data x feature learner; "" = 1-D on the learner's natural axis with tpu_num_devices devices
    tpu_fused_learner: str = "auto"           # auto / 1 / 0: auto and 1 train with the device-resident FusedTreeLearner on the card and on the CPU alike (CEGB and monotone_constraints_method=advanced still go to the serial learner, with a warning); 0 trains with the host-driven SerialTreeLearner
    tpu_fast_predict_rows: int = 10000        # route predict batches up to this many rows through the threaded native traverser
    # -- out-of-core streaming training (docs/performance.md) -------------
    # where the packed binned matrix lives during training:
    #   hbm    — device-resident for the whole run (the historical path;
    #            rows capped by what one chip's HBM holds)
    #   stream — host-RAM (optionally disk-backed) row shards with async
    #            double-buffered H2D window prefetch overlapped with the
    #            histogram/partition passes; trees are bit-identical to
    #            the resident path
    #   auto   — stream when the training set is a ShardedBinnedDataset
    #            (or its estimated device residency exceeds
    #            stream_hbm_budget_mb when that budget is set), hbm
    #            otherwise
    data_residency: str = "auto"              # auto / hbm / stream
    stream_shard_rows: int = 1 << 20          # rows per host shard (last one ragged)
    stream_prefetch_depth: int = 2            # in-flight H2D window transfers (2 = classic double buffer)
    stream_goss_compact: bool = True          # with a sampling mask, transfer only in-bag rows per window (device re-expands; bit-identical)
    stream_spill_dir: str = ""                # when set, shards are np.memmap files here (disk-backed out-of-core)
    stream_hbm_budget_mb: int = 0             # data_residency=auto streams above this estimated residency; 0 = only pre-sharded datasets stream
    stream_sketch_budget: int = 65536         # distinct values kept per feature by the streaming quantile sketch (exact below, GK-compacted above)
    stream_ingest_threshold_mb: int = 256     # data files larger than this load block-wise through the sketch/push path

    # predict_stream — warehouse-scale out-of-core batch scoring
    # (infer/stream.py): host/memmap/file row windows pump through a
    # bounded H2D ring into the configured predict engine; scores stream
    # back through a D2H ring (telemetry phase d2h_scores), with an
    # optional co-tenant throttle fed by the SignalPlane's goodput knee
    predict_stream_window_rows: int = 65536   # rows per scoring window (ragged tails pad to pow2 buckets; bigger windows amortize dispatch, smaller bound HBM)
    predict_stream_depth: int = 0             # in-flight windows per ring; 0 = stream_prefetch_depth
    predict_stream_throttle: str = "auto"     # auto/on/off — auto throttles window issue whenever a signal source is wired; off ignores it
    predict_stream_knee_margin: float = 0.1   # serve-goodput headroom below which the batch job yields (fraction of the measured knee)
    predict_stream_backoff_s: float = 0.05    # first co-tenant backoff delay (doubles per pressured check, bounded below)
    predict_stream_backoff_max_s: float = 2.0  # backoff delay hard cap

    # the JAX package's gradient operand precision for its one-hot MXU
    # histograms (split: a two-term bf16 decomposition, bf16: a raw bf16
    # cast, f32: full float32). The port's histograms come from K1, whose
    # sums are exact: "split" (the default) and "f32" both give them;
    # "bf16" would round the gradients first and is refused by name
    tpu_hist_precision: str = "split"

    # unknown/passthrough params preserved verbatim
    extra: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @staticmethod
    def canonical_name(name: str) -> str:
        name = name.strip().lower()
        return _ALIASES.get(name, name)

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        cfg.update(params or {})
        return cfg

    def update(self, params: Dict[str, Any]) -> None:
        fields = {f.name: f for f in dataclasses.fields(self)}
        seen: Dict[str, str] = {}
        for raw_key, val in params.items():
            key = self.canonical_name(raw_key)
            if key in seen:
                log.warning("%s is set with both %s and %s, using the latter",
                            key, seen[key], raw_key)
            seen[key] = raw_key
            if key == "objective" and isinstance(val, str):
                val = _OBJECTIVE_ALIASES.get(val.strip().lower(), val.strip().lower())
            if key == "boosting" and isinstance(val, str):
                val = {"gbrt": "gbdt", "gbm": "gbdt", "dart": "dart",
                       "rf": "rf", "random_forest": "rf",
                       "goss": "goss"}.get(val.strip().lower(), val.strip().lower())
            if key not in fields:
                self.extra[key] = val
                continue
            f = fields[key]
            try:
                if f.type in ("int", int):
                    setattr(self, key, int(val))
                elif f.type in ("float", float):
                    setattr(self, key, float(val))
                elif f.type in ("bool", bool):
                    setattr(self, key, _parse_bool(val))
                elif key in ("eval_at", "max_bin_by_feature",
                             "serve_buckets"):
                    setattr(self, key, _parse_list(val, int))
                elif key == "monotone_constraints":
                    setattr(self, key, _parse_list(val, int))
                elif key in ("label_gain", "feature_contri", "auc_mu_weights",
                             "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled"):
                    setattr(self, key, _parse_list(val, float))
                elif key == "metric":
                    if isinstance(val, str):
                        setattr(self, key, [m.strip() for m in val.split(",") if m.strip()])
                    elif isinstance(val, (list, tuple)):
                        setattr(self, key, list(val))
                    else:
                        setattr(self, key, [val])
                elif key == "interaction_constraints":
                    setattr(self, key, _parse_interaction_constraints(val))
                else:
                    setattr(self, key, val)
            except (TypeError, ValueError) as e:
                log.fatal("Parameter %s should be of type %s, got %r (%s)",
                          key, f.type, val, e)
        # `boosting=goss` is accepted as alias for gbdt + goss sampling
        # (reference: config.cpp GetBoostingType handling).
        if self.boosting == "goss":
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        self._check()

    @staticmethod
    def _peaks_spec_ok(spec: str) -> bool:
        # cost_plane_peaks syntax: "" or three ':'-separated floats
        if not spec:
            return True
        parts = spec.split(":")
        if len(parts) != 3:
            return False
        try:
            return all(float(p) > 0 for p in parts)
        except ValueError:
            return False

    def _check(self) -> None:
        checks = [
            (self.device_type in DEVICE_TYPES,
             f"device_type must be one of {DEVICE_TYPES}, "
             f"got {self.device_type!r}"),
            (self.num_leaves >= 2, "num_leaves must be >= 2"),
            (self.num_iterations >= 0, "num_iterations must be >= 0"),
            (self.learning_rate > 0, "learning_rate must be > 0"),
            (0 < self.bagging_fraction <= 1, "bagging_fraction in (0, 1]"),
            (0 < self.feature_fraction <= 1, "feature_fraction in (0, 1]"),
            (0 < self.feature_fraction_bynode <= 1, "feature_fraction_bynode in (0, 1]"),
            (self.max_bin > 1, "max_bin must be > 1"),
            (self.min_data_in_bin > 0, "min_data_in_bin must be > 0"),
            (self.lambda_l1 >= 0, "lambda_l1 must be >= 0"),
            (self.lambda_l2 >= 0, "lambda_l2 must be >= 0"),
            (self.min_gain_to_split >= 0, "min_gain_to_split must be >= 0"),
            (0 <= self.drop_rate <= 1, "drop_rate in [0, 1]"),
            (0 <= self.skip_drop <= 1, "skip_drop in [0, 1]"),
            (self.top_rate + self.other_rate <= 1.0, "top_rate + other_rate <= 1"),
            (0 < self.alpha < 1, "alpha in (0, 1)"),
            (self.fair_c > 0, "fair_c must be > 0"),
            (1.0 <= self.tweedie_variance_power < 2.0, "tweedie_variance_power in [1, 2)"),
            (self.lambdarank_truncation_level > 0, "lambdarank_truncation_level > 0"),
            (self.sigmoid > 0, "sigmoid must be > 0"),
            (self.num_class >= 1, "num_class must be >= 1"),
            (self.lambdarank_target in LAMBDARANK_TARGETS,
             f"unknown lambdarank_target {self.lambdarank_target!r}"),
            (self.tree_learner in ("serial", "feature", "data", "voting"),
             f"unknown tree_learner {self.tree_learner!r}"),
            (self.boosting in ("gbdt", "dart", "rf"),
             f"unknown boosting {self.boosting!r}"),
            (self.data_sample_strategy in ("bagging", "goss"),
             f"unknown data_sample_strategy {self.data_sample_strategy!r}"),
            # DART replays dropped trees with constant leaf values and RF
            # averages outputs — both would silently corrupt linear-leaf
            # scores, so the combo is rejected up front (same shape as the
            # num_grad_quant_bins bound: the error names both knobs)
            (not (self.linear_tree and self.boosting != "gbdt"),
             f"linear_tree requires boosting=gbdt "
             f"(got boosting={self.boosting!r}); disable linear_tree or "
             f"use gbdt boosting"),
            (self.monotone_constraints_method in ("basic", "intermediate", "advanced"),
             "unknown monotone_constraints_method"),
            (self.predict_engine in ("tensor", "scan", "compiled"),
             f"unknown predict_engine {self.predict_engine!r}"),
            (self.predict_tree_tile >= 1, "predict_tree_tile must be >= 1"),
            (self.infer_quant in ("auto", "u8", "u16"),
             f"unknown infer_quant {self.infer_quant!r}"),
            (self.infer_node_block_kb >= 1,
             "infer_node_block_kb must be >= 1"),
            (self.infer_row_block >= 0, "infer_row_block must be >= 0"),
            (self.serve_max_batch >= 1, "serve_max_batch must be >= 1"),
            (self.serve_max_delay_ms >= 0, "serve_max_delay_ms must be >= 0"),
            (all(b > 0 for b in self.serve_buckets),
             "serve_buckets must be positive"),
            (self.serve_max_queue >= 0, "serve_max_queue must be >= 0"),
            (self.serve_backpressure in ("reject", "block"),
             f"unknown serve_backpressure {self.serve_backpressure!r}"),
            (self.serve_timeout_ms >= 0, "serve_timeout_ms must be >= 0"),
            (self.serve_swap_breaker >= 0, "serve_swap_breaker must be >= 0"),
            (self.serve_hbm_budget_mb >= 0,
             "serve_hbm_budget_mb must be >= 0"),
            (0.0 <= self.serve_tenant_max_share <= 1.0,
             "serve_tenant_max_share must be in [0, 1]"),
            (self.serve_port >= -1, "serve_port must be >= -1"),
            (self.serve_replicas >= 1, "serve_replicas must be >= 1"),
            (0.0 <= self.serve_trace_sample <= 1.0,
             "serve_trace_sample must be in [0, 1]"),
            (self.serve_trace_ring >= 16,
             "serve_trace_ring must be >= 16"),
            (self.serve_flight_interval_s >= 0,
             "serve_flight_interval_s must be >= 0"),
            (self.fleet_scrape_interval_s >= 0,
             "fleet_scrape_interval_s must be >= 0"),
            (self.fleet_scrape_timeout_s > 0,
             "fleet_scrape_timeout_s must be > 0"),
            (self.serve_autonomics_interval_s > 0,
             "serve_autonomics_interval_s must be > 0"),
            (self.serve_autonomics_revive_backoff_s > 0,
             "serve_autonomics_revive_backoff_s must be > 0"),
            (self.serve_autonomics_revive_backoff_max_s
             >= self.serve_autonomics_revive_backoff_s,
             "serve_autonomics_revive_backoff_max_s must be >= "
             "serve_autonomics_revive_backoff_s"),
            (self.serve_autonomics_probe_window >= 1,
             "serve_autonomics_probe_window must be >= 1"),
            (self.serve_autonomics_scale_out_margin
             < self.serve_autonomics_scale_in_margin,
             "serve_autonomics_scale_out_margin must be < "
             "serve_autonomics_scale_in_margin (the hysteresis band)"),
            (self.serve_autonomics_min_replicas >= 1,
             "serve_autonomics_min_replicas must be >= 1"),
            (self.serve_autonomics_max_replicas == 0
             or self.serve_autonomics_max_replicas
             >= self.serve_autonomics_min_replicas,
             "serve_autonomics_max_replicas must be 0 (off) or >= "
             "serve_autonomics_min_replicas"),
            (self.serve_autonomics_cooldown_s >= 0,
             "serve_autonomics_cooldown_s must be >= 0"),
            (self.serve_autonomics_hysteresis_ticks >= 1,
             "serve_autonomics_hysteresis_ticks must be >= 1"),
            (0.0 <= self.serve_shadow_sample <= 1.0,
             "serve_shadow_sample must be in [0, 1]"),
            (self.loop_shadow_min_requests >= 1,
             "loop_shadow_min_requests must be >= 1"),
            (self.loop_promote_threshold >= 0,
             "loop_promote_threshold must be >= 0"),
            (self.loop_interval_s > 0, "loop_interval_s must be > 0"),
            (self.loop_iters_per_fold >= 1,
             "loop_iters_per_fold must be >= 1"),
            (self.guard_snapshot_keep >= 0,
             "guard_snapshot_keep must be >= 0 (0 = keep all)"),
            (self.guard_nonfinite in ("off", "raise", "skip_tree", "clip"),
             f"unknown guard_nonfinite {self.guard_nonfinite!r}"),
            (self.guard_clip > 0, "guard_clip must be > 0"),
            (self.resume in ("", "auto"),
             f"unknown resume mode {self.resume!r} (only 'auto')"),
            (self.tpu_hist_impl in ("auto", "onehot", "pallas"),
             f"tpu_hist_impl must be auto/onehot/pallas, "
             f"got {self.tpu_hist_impl!r}"),
            (self.tree_layout in ("auto", "gather", "sorted"),
             f"tree_layout must be auto/gather/sorted, "
             f"got {self.tree_layout!r}"),
            (self.data_residency in ("auto", "hbm", "stream"),
             f"data_residency must be auto/hbm/stream, "
             f"got {self.data_residency!r}"),
            (self.stream_shard_rows >= 1,
             "stream_shard_rows must be >= 1"),
            (1 <= self.stream_prefetch_depth <= 16,
             "stream_prefetch_depth must be in [1, 16]"),
            (self.stream_hbm_budget_mb >= 0,
             "stream_hbm_budget_mb must be >= 0"),
            (self.stream_sketch_budget >= 256,
             "stream_sketch_budget must be >= 256"),
            (self.stream_ingest_threshold_mb >= 0,
             "stream_ingest_threshold_mb must be >= 0"),
            (self.predict_stream_window_rows >= 1,
             "predict_stream_window_rows must be >= 1"),
            (0 <= self.predict_stream_depth <= 16,
             "predict_stream_depth must be in [0, 16] (0 = "
             "stream_prefetch_depth)"),
            (self.predict_stream_throttle in ("auto", "on", "off"),
             f"predict_stream_throttle must be auto/on/off, "
             f"got {self.predict_stream_throttle!r}"),
            (0.0 <= self.predict_stream_knee_margin <= 1.0,
             "predict_stream_knee_margin must be in [0, 1]"),
            (self.predict_stream_backoff_s > 0.0,
             "predict_stream_backoff_s must be > 0"),
            (self.predict_stream_backoff_max_s
             >= self.predict_stream_backoff_s,
             "predict_stream_backoff_max_s must be >= "
             "predict_stream_backoff_s"),
            (2 <= self.num_grad_quant_bins <= MAX_QUANT_BINS,
             f"num_grad_quant_bins must be in [2, {MAX_QUANT_BINS}] "
             f"(int8 histogram levels), got {self.num_grad_quant_bins}"),
            (self.telemetry_ring >= 1, "telemetry_ring must be >= 1"),
            (self.telemetry_warmup >= 0, "telemetry_warmup must be >= 0"),
            (self.profile_n_iters >= 1, "profile_n_iters must be >= 1"),
            (self.profile_serve_n_req >= 1,
             "profile_serve_n_req must be >= 1"),
            (self.profile_stream_n_windows >= 1,
             "profile_stream_n_windows must be >= 1"),
            (self.cost_plane_memory in ("compiled", "analytic"),
             f"cost_plane_memory must be compiled/analytic, "
             f"got {self.cost_plane_memory!r}"),
            (self._peaks_spec_ok(self.cost_plane_peaks),
             f"cost_plane_peaks must be 'flops:bandwidth:hbm_bytes' "
             f"(three floats), got {self.cost_plane_peaks!r}"),
        ]
        for ok, msg in checks:
            if not ok:
                log.fatal("Config check failed: %s", msg)
        if self.mesh_shape:
            # syntax errors surface at config time, not at first shard_map
            # trace — including for learners that never build a mesh.
            # Wildcard extents ("0x4" / "2x0") are legal syntax here; their
            # divisibility against the actual device count is checked by
            # resolve_mesh_shape at mesh construction, where every
            # rejection also names mesh_shape. Genuine 2-D dd x ff grids
            # are executed by the fused 2-D learner.
            try:
                shape = _parse_mesh_shape(self.mesh_shape)
            except ValueError as e:
                log.fatal("Config check failed: %s", e)
            else:
                if shape and shape[0] == 0 and shape[1] == 0:
                    log.fatal("Config check failed: mesh_shape cannot be "
                              "0x0 (at most one wildcard extent)")
        if self.boosting == "rf":
            if not (self.bagging_freq > 0 and self.bagging_fraction < 1.0):
                log.fatal("Random forest needs bagging_freq > 0 and bagging_fraction < 1")
        log.set_verbosity(self.verbosity)

    # convenient views ----------------------------------------------------
    @property
    def is_ranking(self) -> bool:
        return self.objective in ("lambdarank", "rank_xendcg")

    @property
    def num_tree_per_iteration(self) -> int:
        return self.num_class if self.objective in ("multiclass", "multiclassova") else 1

    def label_gain_or_default(self, max_label: int) -> List[float]:
        """Default label_gain = 2^i - 1 (reference: config.cpp default fill)."""
        if self.label_gain:
            return list(self.label_gain)
        return [float((1 << i) - 1) if i < 31 else float(2 ** 31 - 1)
                for i in range(max(max_label + 1, 32))]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("extra", None)
        return d


def _parse_mesh_shape(mesh_shape: str):
    """``mesh_shape`` knob -> (data, feature) extents; ``""`` -> None (a
    copy of lambdagap_tpu/parallel/sharding.py parse_mesh_shape)."""
    s = str(mesh_shape).strip().lower()
    if not s:
        return None
    parts = s.replace("*", "x").split("x")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise ValueError(f"mesh_shape must look like '8' or '4x2', "
                         f"got {mesh_shape!r}")
    if len(dims) == 1:
        dims.append(1)
    if len(dims) != 2 or any(d < 0 for d in dims):
        raise ValueError(f"mesh_shape must be 1-D or 2-D non-negative, "
                         f"got {mesh_shape!r}")
    return dims[0], dims[1]


def _parse_interaction_constraints(val: Any) -> List[List[int]]:
    if isinstance(val, str):
        import re
        # CLI format like "[0,1,2],[2,3]" (reference: config.cpp
        # Str2FeatureInteractionVector)
        return [[int(x) for x in grp.split(",") if x.strip()]
                for grp in re.findall(r"\[([^\]]*)\]", val)]
    if isinstance(val, (list, tuple)):
        return [[int(x) for x in g] for g in val]
    return []
