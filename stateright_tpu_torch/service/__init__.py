"""Checking as a service: for now the model zoo (``zoo.py``), which the
conformance plane resolves uploads' model names through. ``CheckService``,
its jobs, HTTP front end and SLO ledger wait for the port of the service.
"""

from .zoo import aot_namespace, default_zoo, warm_shapes

__all__ = ["aot_namespace", "default_zoo", "warm_shapes"]
