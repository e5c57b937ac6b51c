"""Multi-device execution over ``torch.distributed`` (counterpart of
paddle_tpu/parallel/): named meshes over the ranks of a process group, the
sharding plan and the sharded program step (dp, dp×tp, ZeRO-1), the
placement planner that searches and costs the meshes and emits the winner
through that step, ring attention (sp), the expert-parallel MoE FFN (ep),
the microbatch pipeline (pp), multi-host start-up, and a spawner of local
ranks (``launch``)."""

from .sharding import (Mesh, PartitionSpec, ShardingPlan, make_mesh,
                       place_feed, shard_program_step)
from .ring_attention import ring_attention
from .moe import moe_ffn, init_moe_params, shard_moe_params
from .pipeline import (pipeline_apply, shard_pipeline_params,
                       pipeline_stack_reference)
from .multihost import init_multihost, global_mesh
from .planner import (Candidate, PlacementReport, PlanCost, PlanError,
                      PlanStore, ProgramFeatures, apply_candidate,
                      cost_candidate, enumerate_meshes, extract_features,
                      plan)

__all__ = ["ShardingPlan", "make_mesh", "shard_program_step", "place_feed",
           "ring_attention", "init_multihost", "global_mesh",
           "moe_ffn", "init_moe_params", "shard_moe_params",
           "pipeline_apply", "shard_pipeline_params",
           "pipeline_stack_reference", "Mesh", "PartitionSpec",
           "Candidate", "PlacementReport", "PlanCost", "PlanError",
           "PlanStore", "ProgramFeatures", "apply_candidate",
           "cost_candidate", "enumerate_meshes", "extract_features",
           "plan"]
