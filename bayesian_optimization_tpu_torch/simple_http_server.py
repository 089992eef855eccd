"""Alias module: `python -m bayesian_optimization_tpu_torch.simple_http_server
-w PORT [--device cuda|cpu] [-d]` starts the port's ask/tell service, as
the JAX package's module of the same name starts its own."""
from .service.http_server import main

if __name__ == "__main__":
    main()
