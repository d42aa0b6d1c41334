"""Box and point geometry, targets, losses and the box assigners of the
port."""

from . import assigners, losses
from .assigners import (AssignResult, SampleResult, max_iou_assign,
                        random_sample)

__all__ = ["AssignResult", "SampleResult", "assigners", "losses",
           "max_iou_assign", "random_sample"]
