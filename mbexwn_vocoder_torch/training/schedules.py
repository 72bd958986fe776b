"""Loss-weight schedules (teacher forcing, the F0 and spectral loss weights).

Counterpart of the JAX package's training/schedules.py: constant, linear
and exponential ramps from `initial` at `start_step` to `final` at
`end_step`, evaluated at a Python step count to a Python float.
"""
from __future__ import annotations


class ParamSchedule:
    def __init__(self, initial, name, type="constant", final=None, start_step=0, end_step=0, quiet=True, **kwargs):
        self.type = type
        self.initial = initial
        self.final = final if final is not None else initial
        self.start_step = start_step
        self.end_step = end_step
        self.name = name

    def __call__(self, step) -> float:
        if self.type == "constant" or self.end_step <= self.start_step:
            return float(self.initial)
        frac = min(max((step - self.start_step) / (self.end_step - self.start_step), 0.0), 1.0)
        if self.type == "linear":
            return float(self.initial + (self.final - self.initial) * frac)
        if self.type == "exponential":
            return float(self.initial * (self.final / self.initial) ** frac)
        raise RuntimeError(f"ParamSchedule::unknown schedule type {self.type}")

    def get_config(self):
        return {"initial": self.initial, "type": self.type, "name": self.name}
