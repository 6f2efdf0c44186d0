"""Faults planted under the timed path, for the readings and the tests that
show the comparison fails them (``readings.py --fault``,
``tests/test_perfbench_control.py``). Each takes the built engine, breaks
it in place, and returns a function that undoes what it did outside the
engine, or None."""

from __future__ import annotations


def state_unchanged(engine):
    """Each rollout step returns its state unchanged: both rollouts answer
    their input."""
    from midd_tpu_torch.serve import engine as eng

    orig = eng.denoise
    eng.denoise = lambda eps_fn, noisy, *a, **k: noisy.clone()

    def undo():
        eng.denoise = orig

    return undo


def half_batch(engine):
    """Each path computes the first half of a batch's rows; the others get
    the mean of those."""
    import torch

    for name, fn in list(engine._paths.items()):
        def half(x, _fn=fn):
            keep = (x.shape[0] + 1) // 2
            y = _fn(x[:keep])
            return torch.cat([y, y.mean(0, keepdim=True).expand(x.shape[0] - keep, *y.shape[1:])])

        engine._paths[name] = half


def _altered(engine, path):
    fn = engine._paths[path]
    engine._paths[path] = lambda x: (fn(x) + 2 / 255).clamp(0, 1)


def answer_altered(engine):
    """The NAFNet path's answer is off by two levels where it is produced."""
    _altered(engine, "nafnet")


def hybrid_altered(engine):
    """The hybrid path's answer is off by two levels where it is produced."""
    _altered(engine, "hybrid")


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered, hybrid_altered)}
