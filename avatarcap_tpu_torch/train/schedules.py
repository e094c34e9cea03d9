"""Learning-rate schedules (counterpart of avatarcap_tpu/train/schedules.py,
the reference's utils/lr_schedule.py)."""

from __future__ import annotations


class ConstantSchedule:
    def __init__(self, value: float):
        self.value = value

    def __call__(self, step: int) -> float:
        return self.value


class StepSchedule:
    """Geometric decay: ``initial * factor ** (step // interval)``."""

    def __init__(self, initial: float, interval: int, factor: float):
        self.initial = initial
        self.interval = interval
        self.factor = factor

    def __call__(self, step: int) -> float:
        return self.initial * (self.factor ** (step // self.interval))


class WarmupSchedule:
    """Linear warmup from ``initial`` to ``warmed_up`` over ``length``
    steps, then constant."""

    def __init__(self, initial: float, warmed_up: float, length: int):
        self.initial = initial
        self.warmed_up = warmed_up
        self.length = length

    def __call__(self, step: int) -> float:
        if step > self.length:
            return self.warmed_up
        return self.initial + (self.warmed_up - self.initial) \
            * step / self.length


_REQUIRED = {"Step": ("Initial", "Interval", "Factor"),
             "Warmup": ("Initial", "Final", "Length"),
             "Constant": ("Value",)}


def get_learning_rate_schedule(kind: str, **kwargs):
    """Schedule from the reference config's keywords: ``Step`` (Initial,
    Interval, Factor), ``Warmup`` (Initial, Final, Length) or ``Constant``
    (Value). Raises ValueError for an unknown kind or a missing keyword."""
    if kind not in _REQUIRED:
        raise ValueError(f'Unknown learning rate schedule type "{kind}"! '
                         'Must be "Step", "Warmup" or "Constant".')
    for k in _REQUIRED[kind]:
        if k not in kwargs:
            raise ValueError(f'Missing keyword argument "{k}"')
    if kind == "Step":
        return StepSchedule(kwargs["Initial"], kwargs["Interval"],
                            kwargs["Factor"])
    if kind == "Warmup":
        return WarmupSchedule(kwargs["Initial"], kwargs["Final"],
                              kwargs["Length"])
    return ConstantSchedule(kwargs["Value"])
