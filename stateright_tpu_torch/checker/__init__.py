"""The port's checkers. The tenant-packed engine and its tenants' handle
are exported here."""

from .packed_tenancy import TenantPackedEngine, TenantRun

__all__ = ["TenantPackedEngine", "TenantRun"]
