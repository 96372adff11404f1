"""Action contracts + host action transport — the TPU framework's
equivalent of ``dddmr_sys_core``'s ROS 2 action layer
(`action/GetPlan.action`, `action/PToPMoveBase.action`,
`action/RecoveryBehaviors.action`, `action/TagDocking.action` and the
detached goal threads every node spawns, e.g. `p2p_move_base.cpp:58-72`).

DDS actions become a small in-process goal-handle protocol: a server
registers an ``execute(goal, handle)`` callable; clients submit goals and
poll/await results. Each goal runs on its own daemon thread (the
reference's detached ``std::thread`` per goal), with cancel and
preemption (new goal interrupts the old — PToPMoveBase semantics).
Device work stays inside jitted steps; this layer only moves goals,
feedback, and results between host components.

The port's own copy of ``dddmr_navigation_tpu/runtime/actions.py`` (the
standard library only); ``tests/test_torch_runtime_io.py`` holds it to the
original.
"""
from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class GoalStatus(enum.IntEnum):
    PENDING = 0
    EXECUTING = 1
    SUCCEEDED = 2
    ABORTED = 3
    CANCELED = 4


@dataclass
class GetPlanGoal:
    """`GetPlan.action`: goal/start poses (+ DWA threading switch)."""
    goal: Any
    start: Any = None
    activate_threading: bool = True


@dataclass
class GetPlanResult:
    path: Any = None
    planning_time: float = 0.0


@dataclass
class PToPMoveBaseGoal:
    """`PToPMoveBase.action`: a target pose."""
    target_pose: Any = None


@dataclass
class RecoveryGoal:
    """`RecoveryBehaviors.action`: behavior selected by name."""
    behavior_name: str = "rotate_inplace"


@dataclass
class TagDockingGoal:
    """`TagDocking.action` goal: start the docking maneuver. The reference
    ships only the contract (`action/TagDocking.action`), no server."""
    start: bool = True


@dataclass
class TagDockingResult:
    succeed: bool = False


@dataclass
class GoalHandle:
    """Server-side view of one in-flight goal."""
    goal: Any
    status: GoalStatus = GoalStatus.PENDING
    result: Any = None
    feedback: Any = None
    _cancel: threading.Event = field(default_factory=threading.Event)
    _done: threading.Event = field(default_factory=threading.Event)

    def is_cancel_requested(self) -> bool:
        return self._cancel.is_set()

    def publish_feedback(self, fb) -> None:
        self.feedback = fb

    def succeed(self, result=None) -> None:
        self.result = result
        self.status = GoalStatus.SUCCEEDED
        self._done.set()

    def abort(self, result=None) -> None:
        self.result = result
        self.status = GoalStatus.ABORTED
        self._done.set()

    def canceled(self, result=None) -> None:
        self.result = result
        self.status = GoalStatus.CANCELED
        self._done.set()

    # client side --------------------------------------------------------
    def cancel(self) -> None:
        self._cancel.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the goal finishes; returns (status, result)."""
        self._done.wait(timeout)
        return self.status, self.result


class ActionServer:
    """One action name → one execute callback; one goal at a time with
    preemption (the reference accepts a new goal and cancels the running
    one, `p2p_move_base.cpp:192-215`)."""

    def __init__(self, name: str,
                 execute: Callable[[Any, GoalHandle], None],
                 preempt: bool = True):
        self.name = name
        self._execute = execute
        self._preempt = preempt
        self._current: Optional[GoalHandle] = None
        self._lock = threading.Lock()

    def submit(self, goal) -> GoalHandle:
        with self._lock:
            if self._current is not None and not self._current.done():
                if not self._preempt:
                    h = GoalHandle(goal=goal)
                    h.abort()
                    return h
                self._current.cancel()
                self._current._done.wait(timeout=5.0)
            handle = GoalHandle(goal=goal, status=GoalStatus.EXECUTING)
            self._current = handle

        def run():
            try:
                self._execute(goal, handle)
                if not handle.done():
                    handle.succeed(handle.result)
            except Exception as e:  # execution error → aborted
                handle.abort(result=e)

        threading.Thread(target=run, daemon=True).start()
        return handle


class ActionClient:
    """Client wrapper: submit + optional synchronous wait."""

    def __init__(self, server: ActionServer):
        self._server = server

    def send_goal(self, goal) -> GoalHandle:
        return self._server.submit(goal)

    def call(self, goal, timeout: Optional[float] = None):
        h = self._server.submit(goal)
        return h.wait(timeout)


class PeriodicTimer:
    """Wall-clock periodic callback thread — the reference's node timers
    (`create_wall_timer`). Start/stop-gated like the global-plan
    manager's resume/stop (`p2p_global_plan_manager.cpp:83-106`)."""

    def __init__(self, frequency: float, cb: Callable[[], None]):
        self.period = 1.0 / frequency
        self._cb = cb
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            nxt = time.monotonic()
            while not self._stop.is_set():
                self._cb()
                nxt += self.period
                delay = nxt - time.monotonic()
                if delay > 0:
                    self._stop.wait(delay)
                else:
                    nxt = time.monotonic()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
