"""The program's own spans (``videowalk_tpu_torch/utils/profile.py``): its
recorder is on while a profiler session records, so it holds the spans of
the window's traced stretches. A program without that recorder gives no
reading."""

from __future__ import annotations


def summary() -> dict | None:
    """The recorder's ``summary()``, or None where the program has none."""
    from videowalk_tpu_torch.utils import profile

    read = getattr(profile, "summary", None)
    return read() if read is not None else None


def per_root(ctx, root: str, names: tuple, field: str) -> float | None:
    """``field`` (``device_ms`` or ``host_ms``) summed over the spans
    ``names``, over the number of ``root`` spans (``step``, ``video``) in
    the traced stretches; None without a trace, a root span or a reading
    of every name."""
    if ctx.trace is None:
        return None
    spans = summary()
    if not spans or not spans.get(root, {}).get("n"):
        return None
    values = [spans.get(name, {}).get(field) for name in names]
    if any(v is None for v in values):
        return None
    return sum(values) / spans[root]["n"]
