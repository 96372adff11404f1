"""The global planner on the shared ground graph, batched over robots
(counterpart of ``dddmr_navigation_tpu/planning/global_``): the graph, the
wavefront, the LOS gate, the planner, the host runtime
(``runtime.GlobalPlannerRuntime``) and the DWA look-ahead manager
(``dwa.DWAGlobalPlanManager``)."""
