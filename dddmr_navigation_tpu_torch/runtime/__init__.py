"""Host runtime: actions, timers, watchdogs, checkpointing, tracing and the
operator viewers (counterpart of ``dddmr_navigation_tpu/runtime``, the
"DDS role" around the compute core)."""
from dddmr_navigation_tpu_torch.runtime.actions import (
    GoalStatus, GoalHandle, ActionServer, ActionClient, PeriodicTimer,
    GetPlanGoal, GetPlanResult, PToPMoveBaseGoal, RecoveryGoal,
    TagDockingGoal, TagDockingResult)
from dddmr_navigation_tpu_torch.runtime.watchdog import (
    FreshnessGate, TickMonitor)
from dddmr_navigation_tpu_torch.runtime.checkpoint import (
    save_pytree, restore_pytree, CheckpointManager)
from dddmr_navigation_tpu_torch.runtime.tracing import trace, DebugDumper
from dddmr_navigation_tpu_torch.runtime.viewer import NavViewer
from dddmr_navigation_tpu_torch.runtime.viewer3d import PoseGraph3DViewer
