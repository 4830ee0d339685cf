"""repro_torch.core — libhclooc's contribution on one CUDA device.

Port of ``src/repro/core/__init__.py`` for this slice's modules:

  * plan_gemm_partition / plan_attention_partition  (hclMatrixPartitioner)
  * PipelineSpec / compile_pipeline + the kernel specs (gemm / attention /
    syrk / vendor / factor) and their build_*_schedule wrappers
  * validate_schedule, simulate, hardware models
  * ooc_gemm / ooc_syrk                              (MMOOC)
  * ScheduleExecutor / register_op_handler           (the one interpreter)
  * HostOocRuntime / VmemOocRuntime                  (hclRuntime hierarchy)
  * from_reference                                   (state carried across)
  * api: hcl-prefixed facade for paper-parity code
"""

from repro_torch.core.convert import from_reference
from repro_torch.core.oocgemm import (is_in_core, ooc_gemm, ooc_syrk,
                                      plan_for_device)
from repro_torch.core.partitioner import (
    TRAVERSALS,
    AttentionPartition,
    GemmPartition,
    plan_attention_partition,
    plan_gemm_partition,
    traversal_order,
)
from repro_torch.core.pipeline import (
    EVICT_POLICIES,
    BlockCache,
    ComputeStage,
    FactorPipelineSpec,
    PipelineSpec,
    StreamedOperand,
    WriteBack,
    attention_pipeline_spec,
    build_attention_schedule,
    build_gemm_schedule,
    build_syrk_schedule,
    build_vendor_schedule,
    compile_factor_pipeline,
    compile_pipeline,
    factor_pipeline_spec,
    gemm_pipeline_spec,
    schedule_stats,
    syrk_pipeline_spec,
    vendor_pipeline_spec,
)
from repro_torch.core.exec_plan import (
    ExecutablePlan,
    compile_executable,
    plan_cache_stats,
)
from repro_torch.core.runtime import (
    ExecState,
    HostOocRuntime,
    OocRuntime,
    RuntimeFactory,
    ScheduleExecutor,
    VmemOocRuntime,
    register_op_handler,
    register_runtime,
    resolve_device,
    tier_bytes,
)
from repro_torch.core.simulator import (
    HardwareModel,
    SimResult,
    gpu_like,
    phi_like,
    simulate,
    simulate_reference,
)
from repro_torch.core.trace import (
    chrome_trace,
    chrome_trace_groups,
    write_chrome_trace,
    write_chrome_trace_groups,
)
from repro_torch.core.streams import (
    BlockRef,
    Device,
    Event,
    Op,
    OpKind,
    Schedule,
    ScheduleError,
    SliceRef,
    Stream,
    StreamFactory,
    validate_schedule,
)

__all__ = [
    "AttentionPartition", "BlockCache", "BlockRef", "ComputeStage",
    "Device", "EVICT_POLICIES", "Event",
    "ExecState", "ExecutablePlan", "FactorPipelineSpec", "GemmPartition",
    "HardwareModel", "HostOocRuntime", "Op", "OpKind", "OocRuntime",
    "PipelineSpec", "RuntimeFactory", "Schedule", "ScheduleError",
    "ScheduleExecutor", "SimResult", "SliceRef", "Stream", "StreamFactory",
    "StreamedOperand", "TRAVERSALS", "VmemOocRuntime", "WriteBack",
    "attention_pipeline_spec", "build_attention_schedule",
    "build_gemm_schedule", "build_syrk_schedule", "build_vendor_schedule",
    "chrome_trace", "chrome_trace_groups", "compile_executable",
    "compile_factor_pipeline", "compile_pipeline", "factor_pipeline_spec",
    "from_reference", "gemm_pipeline_spec", "gpu_like", "is_in_core",
    "ooc_gemm", "ooc_syrk", "phi_like", "plan_attention_partition",
    "plan_cache_stats", "plan_for_device", "plan_gemm_partition",
    "register_op_handler", "register_runtime", "resolve_device",
    "schedule_stats", "simulate", "simulate_reference",
    "syrk_pipeline_spec", "tier_bytes", "traversal_order",
    "validate_schedule", "vendor_pipeline_spec", "write_chrome_trace",
    "write_chrome_trace_groups",
]
