"""Remote ask/tell HTTP service + daemonization."""
from .http_server import OptimizationService, serve

__all__ = ["OptimizationService", "serve"]
