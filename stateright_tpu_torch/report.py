"""Progress reporting during model checking.

Reference: ``src/report.rs``. The exact output strings
(``Checking. states=..``, ``Done. states=.., sec=..``,
``Discovered "name" example Path[n]``, ``Fingerprint path: ..``) are part of
the compatibility surface — golden-tested and grepped by bench harnesses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import IO, Dict


@dataclass
class ReportData:
    total_states: int
    unique_states: int
    max_depth: int
    duration_secs: float
    done: bool


@dataclass
class ReportDiscovery:
    path: "Path"
    classification: str  # "example" | "counterexample"


class Reporter:
    def report_checking(self, data: ReportData) -> None:
        raise NotImplementedError

    def report_discoveries(self, discoveries: Dict[str, ReportDiscovery]) -> None:
        raise NotImplementedError

    def report_undiscovered(self, properties) -> None:
        """Called once at run end (completed runs only) with the
        sometimes/eventually properties that have NO discovery, so a
        vacuous pass — a ``sometimes`` never witnessed — is visible even
        without the coverage ledger (upstream-parity: see MIGRATING.md).
        Default no-op keeps existing reporters source-compatible."""

    def report_liveness(self, inconclusive=(), skipped_crashed=False,
                        ) -> None:
        """Liveness-pass honesty lines: properties the bounded host
        post-pass could not certify within its budget, and the
        crashed-run warning (a missing counterexample must never be
        mistaken for certified absence). Default no-op keeps existing
        reporters source-compatible."""

    def report_config_notes(self, notes) -> None:
        """Called once per report with the configuration adjustments the
        checker made on the user's behalf (e.g. the tile-sweep kernels
        rounding ``table_capacity`` up to a tile-aligned power of two), so
        an adjusted run never reads as the run that was asked for. Default
        no-op keeps existing reporters source-compatible."""

    def delay(self) -> float:
        """Seconds between progress reports."""
        return 1.0


class WriteReporter(Reporter):
    def __init__(self, writer: IO[str]):
        self.writer = writer

    def report_checking(self, data: ReportData) -> None:
        if data.done:
            self.writer.write(
                f"Done. states={data.total_states}, unique={data.unique_states}, "
                f"depth={data.max_depth}, sec={int(data.duration_secs)}\n"
            )
        else:
            self.writer.write(
                f"Checking. states={data.total_states}, "
                f"unique={data.unique_states}, depth={data.max_depth}\n"
            )

    def report_discoveries(self, discoveries) -> None:
        for name in sorted(discoveries):
            discovery = discoveries[name]
            self.writer.write(
                f'Discovered "{name}" {discovery.classification} {discovery.path}'
            )
            self.writer.write(f"Fingerprint path: {discovery.path.encode()}\n")

    def report_undiscovered(self, properties) -> None:
        # Golden-surface extension: one line per undiscovered
        # sometimes/eventually property. For "sometimes" this is the
        # vacuity warning (an example was sought and never found); for
        # "eventually" it is the explicit all-clear.
        for p in sorted(properties, key=lambda p: p.name):
            kind = getattr(p.expectation, "value", str(p.expectation))
            self.writer.write(
                f'Property "{p.name}" not discovered ({kind})\n'
            )

    def report_liveness(self, inconclusive=(), skipped_crashed=False,
                        ) -> None:
        for name in sorted(inconclusive):
            self.writer.write(
                f'Liveness "{name}" inconclusive '
                "(host post-pass budget exhausted; absence NOT "
                "certified)\n"
            )
        if skipped_crashed:
            self.writer.write(
                "Liveness pass skipped: run crashed; absence of "
                "counterexamples NOT certified\n"
            )

    def report_config_notes(self, notes) -> None:
        for note in notes:
            self.writer.write(f"Note: {note}\n")
