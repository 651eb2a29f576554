"""``trunk.bn_fused_share``: the share, in %, of the trunk's train-mode BN
applications (forward and backward, each BN once each way) in the traced
stretches that ran on the hand-written BN kernels: the ``bn_fused`` and
``bn_plain`` counts of the program's ``trunk`` and ``trunk.backward``
spans (``ops/bn_act.py``). None on a program whose spans carry no such
counts."""

from harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    summary = spans.summary()
    if not summary:
        return None
    fused = plain = 0
    for name in ("trunk", "trunk.backward"):
        counts = summary.get(name, {}).get("counts", {})
        fused += counts.get("bn_fused", 0)
        plain += counts.get("bn_plain", 0)
    if fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
