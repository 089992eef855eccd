"""Carry a fitted GP's state, and an ES's state, across from numpy arrays.

The JAX package's `PosteriorState` and `GPConfig` are NamedTuples with the
same fields as the port's. Turned into plain numpy (`state._asdict()` with
each value through `np.asarray`), they load here, so the port can predict
and maximise an acquisition from exactly the posterior the JAX package
fitted -- how the parity tests hold the two packages to each other; a
stacked ensemble state too, and in float64 where a test needs it. The same
holds for the CMA chains' `CMAState` and MIES's `MIESState`, whose JAX PRNG
key gives way to a torch.Generator, and for what an HMC/NUTS fit carries
into its next refit. A fitted JAX `RandomForest`'s `RFState` loads the same
way (`rf_state_from_numpy`), so the port traverses exactly its forest.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..optim.cma import CMAState
from ..optim.mies import MIESState
from .likelihood import GPConfig, PosteriorState
from .random_forest import RFConfig, RFState


def posterior_state_from_numpy(fields: Mapping[str, np.ndarray], device,
                               dtype=torch.float32) -> PosteriorState:
    """PosteriorState on `device` in `dtype` from a dict of numpy arrays. A
    stacked state (the JAX package's vmapped ensemble, a leading S axis on
    every field) keeps that axis on every field but X and mask, which its
    members share: the port's stacked layout."""
    missing = set(PosteriorState._fields) - set(fields)
    if missing:
        raise ValueError(f"posterior state fields missing: {sorted(missing)}")
    fields = dict(fields)
    if np.ndim(fields["X"]) == 3:
        fields["X"], fields["mask"] = np.asarray(fields["X"])[0], np.asarray(fields["mask"])[0]
    return PosteriorState(**{
        k: torch.as_tensor(np.array(fields[k]), device=device).to(dtype)
        for k in PosteriorState._fields
    })


def gpconfig_from_fields(fields: Mapping) -> GPConfig:
    """GPConfig from a dict of its fields (unknown keys are an error)."""
    unknown = set(fields) - set(GPConfig._fields)
    if unknown:
        raise ValueError(f"unknown GPConfig fields: {sorted(unknown)}")
    return GPConfig(**dict(fields))


def carry_sampler_state(gp, sampler_carry, map_par_log10) -> None:
    """Give the port's GaussianProcess `gp` what a JAX package's HMC/NUTS fit
    carries into its next refit: `_sampler_carry` (inv_mass (C, P),
    step_size (C,), (optimizer, n_pad)) and `_map_par_log10` (P,), so that
    gp's next fit starts its chains where the JAX model's next fit would."""
    inv_mass, step, key = sampler_carry
    gp._sampler_carry = (np.asarray(inv_mass, dtype=float), np.asarray(step, dtype=float),
                         tuple(key))
    gp._map_par_log10 = np.asarray(map_par_log10, dtype=float)


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


def rf_state_from_numpy(fields: Mapping[str, np.ndarray], max_depth: int, device,
                        dtype=torch.float32):
    """(RFState, RFConfig) on `device` from the numpy fields of the JAX
    package's RFState and its max_depth: int32 feature/left/right, the
    threshold as given (float32 there), the values in `dtype`."""
    missing = set(RFState._fields) - set(fields)
    if missing:
        raise ValueError(f"RFState fields missing: {sorted(missing)}")

    def arr(k):
        return torch.as_tensor(np.array(fields[k]), device=device)

    state = RFState(feature=arr("feature").to(torch.int32), threshold=arr("threshold"),
                    left=arr("left").to(torch.int32), right=arr("right").to(torch.int32),
                    value=arr("value").to(dtype))
    return state, RFConfig(max_depth=int(max_depth))
