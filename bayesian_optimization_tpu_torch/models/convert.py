"""Carry a fitted GP's state, and an ES's state, across from numpy arrays.

The JAX package's `PosteriorState` and `GPConfig` are NamedTuples with the
same fields as the port's. Turned into plain numpy (`state._asdict()` with
each value through `np.asarray`), they load here, so the port can predict
and maximise an acquisition from exactly the posterior the JAX package
fitted -- how the parity tests hold the two packages to each other. The
same holds for the CMA chains' `CMAState` and MIES's `MIESState`, whose
JAX PRNG key gives way to a torch.Generator.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..optim.cma import CMAState
from ..optim.mies import MIESState
from .likelihood import GPConfig, PosteriorState


def posterior_state_from_numpy(fields: Mapping[str, np.ndarray], device) -> PosteriorState:
    """PosteriorState on `device` (float32) from a dict of numpy arrays."""
    missing = set(PosteriorState._fields) - set(fields)
    if missing:
        raise ValueError(f"posterior state fields missing: {sorted(missing)}")
    return PosteriorState(**{
        k: torch.as_tensor(np.array(fields[k], dtype=np.float32), device=device)
        for k in PosteriorState._fields
    })


def gpconfig_from_fields(fields: Mapping) -> GPConfig:
    """GPConfig from a dict of its fields (unknown keys are an error)."""
    unknown = set(fields) - set(GPConfig._fields)
    if unknown:
        raise ValueError(f"unknown GPConfig fields: {sorted(unknown)}")
    return GPConfig(**dict(fields))


def _es_state(cls, fields: Mapping[str, np.ndarray], gen: torch.Generator, device):
    names = [k for k in cls._fields if k != "gen"]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"{cls.__name__} fields missing: {sorted(missing)}")
    return cls(**{k: torch.as_tensor(np.array(fields[k], dtype=np.float32), device=device)
                  for k in names}, gen=gen)


def cma_state_from_numpy(fields: Mapping[str, np.ndarray], gen: torch.Generator,
                         device) -> CMAState:
    """CMAState on `device` (float32) from the numpy fields of the JAX
    package's CMAState; its `key` is ignored, `gen` draws from then on."""
    return _es_state(CMAState, fields, gen, device)


def mies_state_from_numpy(fields: Mapping[str, np.ndarray], gen: torch.Generator,
                          device) -> MIESState:
    """MIESState on `device` (float32) from the numpy fields of the JAX
    package's MIESState; its `key` is ignored, `gen` draws from then on."""
    return _es_state(MIESState, fields, gen, device)
