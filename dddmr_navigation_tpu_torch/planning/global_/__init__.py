"""The global planner on the shared ground graph, batched over robots
(counterpart of ``dddmr_navigation_tpu/planning/global_``)."""

_NOT_PORTED = {
    "dwa": "the DWA look-ahead planner", "DWAGlobalPlanManager": "dwa.py",
    "runtime": "the host runtime", "GlobalPlannerRuntime": "runtime.py"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet ({_NOT_PORTED[name]})")
    raise AttributeError(name)
