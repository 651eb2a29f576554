"""What every cell shares: the files found by name, seeds, the seeded
weights, the guard against the JAX package, and the result line."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "videowalk_tpu")


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell's ``BENCHMARK.json`` entry with its configuration, traffic
    mix, check limits and per-layer metrics, each read from its own file
    under ``benchmark/`` by the name the entry gives."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    config = read_json(os.path.join(root, config_entry["file"]))
    traffic = read_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    checks = read_json(os.path.join(BENCH_DIR, "checks", workload + ".json"))

    def reported(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(name=workload, chips=cell["chips"], config=config,
                config_name=cell["config"], traffic=traffic,
                traffic_name=cell["traffic"], checks=checks,
                end_to_end=[m for m in bench["end_to_end"] if reported(m)],
                per_layer=[m for m in bench["per_layer"] if reported(m)])


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def seeded_weights(template: dict, seed: int, device) -> dict:
    """New values for every entry of ``template`` (a model's
    ``state_dict``), made on ``device`` from ``seed`` in two draws: conv
    and linear weights ~ N(0, 2 / fan_out) (He, as torchvision's ResNet),
    BN weights ~ 1 + 0.1 N, biases and running means ~ 0.1 N, running
    variances ~ U(0.5, 1.5); integer buffers zero."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights"))
    mats = [k for k, v in template.items() if v.dim() >= 2]
    vecs = [k for k, v in template.items()
            if v.dim() == 1 and v.is_floating_point()]
    flat_m = torch.randn(sum(template[k].numel() for k in mats),
                         generator=gen, device=device)
    flat_v = torch.randn(sum(template[k].numel() for k in vecs),
                         generator=gen, device=device)
    out, o = {}, 0
    for k in mats:
        shape = template[k].shape
        fan = shape[0] * math.prod(shape[2:]) if len(shape) > 2 else shape[1]
        n = template[k].numel()
        out[k] = flat_m[o:o + n].view(shape) * math.sqrt(2.0 / fan)
        o += n
    o = 0
    for k in vecs:
        n = template[k].numel()
        r = flat_v[o:o + n]
        o += n
        if k.endswith("running_var"):
            r = 0.5 + torch.special.ndtr(r)
        elif k.endswith(".weight"):
            r = 1.0 + 0.1 * r
        else:
            r = 0.1 * r
        out[k] = r
    for k, v in template.items():
        if k not in out:
            out[k] = torch.zeros_like(v, device=device)
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def quantile(values, q: float) -> float:
    """The ``q`` quantile by linear interpolation between order
    statistics."""
    import numpy as np

    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)
