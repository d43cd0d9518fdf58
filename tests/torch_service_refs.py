"""Shared fixtures of the port's service tests (``test_torch_service*.py``,
``test_torch_warmstart.py``, ``test_torch_async_solo.py``).

- ``SPAWN``: the JAX service suites' 2pc shape (frontier 16, table 2^12,
  drains of at most two waves).
- ``jax_ref(rm, dedup)``: the JAX reference verdict of 2pc-``rm`` at that
  shape, computed once a process: ``spawn_tpu_bfs(hashset_impl="xla",
  wave_dedup=dedup)``. ``"sort"`` is the reference of a port job that runs
  solo (``spawn_gpu_bfs`` compacts in key order); ``"scatter"`` is the
  reference of a packed tenant (the pack compacts in lane order, as the JAX
  pack and the JAX solo scatter run do). Fields: ``unique``, ``states``,
  ``max_depth``, ``discoveries`` (name -> path length), ``golden`` (the
  report with every discovery's replayed path, ``sec=`` masked).
- ``golden(text)``: a report with ``sec=`` masked and the port's engine
  note dropped (``wave_kernel resolved to ...``: the port names the engine
  its default picked, a line the JAX run has no counterpart for).
- ``ManualClock``: the service clock the tests step by hand, so quanta,
  timeouts and the stall watchdog fire when a test says and never from a
  wall-clock race.
- ``wait_stalled(inj)``: waits until a ``wave.stall`` fault has parked a
  solo job's worker at a known point, the window in which a test steps the
  clock, cancels or closes.
"""

import functools
import io
import re
import threading
import time

SPAWN = {
    "frontier_capacity": 16,
    "table_capacity": 1 << 12,
    "max_drain_waves": 2,
}
UNIQUE = {3: 288, 4: 1568, 5: 8832}


def golden(text):
    text = re.sub(r"sec=\d+", "sec=_", text)
    return "".join(
        line for line in text.splitlines(keepends=True)
        if "wave_kernel resolved to" not in line
    )


@functools.lru_cache(maxsize=None)
def jax_ref(rm: int, dedup: str, max_drain_waves: int = 2):
    from stateright_tpu import WriteReporter as JaxWriteReporter
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JaxTwoPhaseSys

    c = JaxTwoPhaseSys(rm).checker().spawn_tpu_bfs(
        frontier_capacity=16, table_capacity=1 << 12,
        max_drain_waves=max_drain_waves, hashset_impl="xla", wave_dedup=dedup,
    ).join()
    out = io.StringIO()
    c.report(JaxWriteReporter(out))
    return {
        "unique": c.unique_state_count(),
        "states": c.state_count(),
        "max_depth": c.max_depth(),
        "discoveries": {name: len(path) for name, path in c.discoveries().items()},
        "golden": golden(out.getvalue()),
    }


def assert_verdict(result, ref, *, report=True):
    """A service result equals a JAX reference: counts, depth, discovery
    names and (``report``) the golden report with its paths."""
    assert result["unique"] == ref["unique"]
    assert result["states"] == ref["states"]
    assert result["max_depth"] == ref["max_depth"]
    assert set(result["discoveries"]) == set(ref["discoveries"])
    for name, length in ref["discoveries"].items():
        assert result["discoveries"][name]["length"] == length, name
    if report:
        assert golden(result["report"]) == ref["golden"]


class ManualClock:
    """A monotonic clock that moves only when ``advance`` is called."""

    def __init__(self, t: float = 1000.0):
        self._t = t
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> None:
        with self._lock:
            self._t += dt


def wait_for(pred, timeout: float = 120.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def wait_stalled(inj, n: int = 1, timeout: float = 120.0):
    """Waits until the injector's stall number ``n`` has begun."""
    wait_for(lambda: inj.triggered() >= n, timeout, "the injected stall")
