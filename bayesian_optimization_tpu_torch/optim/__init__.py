"""Acquisition argmax: batched multi-start L-BFGS."""
from .argmax import AcquisitionArgmax, make_unit_criterion

__all__ = ["AcquisitionArgmax", "make_unit_criterion"]
