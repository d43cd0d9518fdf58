"""stateright_tpu_torch: the PyTorch/CUDA port of ``stateright_tpu``.

An explicit-state model checker whose breadth-first search runs on an
NVIDIA GPU: frontier waves are batched torch code, and the visited-set
insert is a hand-written CUDA kernel (``csrc/hashset_insert.cu``). The JAX
package ``stateright_tpu`` is the reference; this package imports neither
it nor JAX, and gives the same counts, fingerprints, verdicts and
counterexample paths.

"Reference" in docstrings means upstream stateright (Rust) and its
sources (``src/...``, ``examples/...``).

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    checker = TwoPhaseSys(8).checker().spawn_gpu_bfs().join()  # on cuda
    checker.assert_properties()
"""

from .checker.base import Checker
from .checker.builder import CheckerBuilder
from .core.batch import BatchableModel
from .core.fingerprint import fingerprint, stable_hash
from .core.model import Expectation, FnModel, Model, Property
from .core.path import Path
from .core.visitor import CheckerVisitor, FnVisitor, PathRecorder, StateRecorder
from .report import ReportData, ReportDiscovery, Reporter, WriteReporter

__all__ = [
    "BatchableModel",
    "Checker",
    "CheckerBuilder",
    "CheckerVisitor",
    "Expectation",
    "FnModel",
    "FnVisitor",
    "Model",
    "Path",
    "PathRecorder",
    "Property",
    "ReportData",
    "ReportDiscovery",
    "Reporter",
    "StateRecorder",
    "WriteReporter",
    "fingerprint",
    "stable_hash",
]
