"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the seeded inputs handed to both sides, the window's
clock, the per-layer readers and the result line.

A cell names a configuration (``vosbench/configs/<config>.json``) and a
traffic mix (``vosbench/traffic/<traffic>.json``, whose ``driver`` names
``vosbench/drivers/<driver>.py``); its correctness limits are in
``vosbench/workloads/<cell>.json``. A per-layer metric ``<name>`` is read
by ``vosbench/metrics/<name>.py``, else by the module named by the part of
``<name>`` before its first dot. An end-to-end metric ``<name>`` is the
driver's number of that name, else of the part before its first dot (one
number under two bounds: ``video_fps`` and ``video_fps.fp32``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "swem_tpu")
MODEL_KEYS = ("backbone", "keydim", "valdim", "num_bases", "num_em_iters", "em_tau", "topl",
              "max_objs", "mdim", "dtype")


@dataclass
class Cell:
    name: str
    chips: int
    mcfg: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # {number: limit}
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    mcfg = _json(ROOT / conf["file"])
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits_path = HERE / "workloads" / f"{name}.json"
    limits = _json(limits_path)["limits"] if limits_path.exists() else {}

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, entry["chips"], mcfg, traffic, limits, e2e, per_layer)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"vosbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py")


def reader(metric: str):
    """The reader of per-layer metric ``metric``."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path)
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r} under vosbench/metrics")


def model_config(cell: Cell, **override):
    """The program's ``ModelConfig`` from the configuration file."""
    from swem_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: cell.mcfg[k] for k in MODEL_KEYS}, **override)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the JAX
    package's (``swem_tpu_torch`` is not ``swem_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def draw_bases(seed: int, count: int, batch: int, cfg: dict, device):
    """``count`` independent draws of the initial EM bases at ``batch`` rows,
    made on the device from ``seed`` in one call each for kappa: a list of
    the reference's ``Bases``."""
    import torch

    from vosbench.reference.memory import Bases, l2norm

    g = torch.Generator(device=device).manual_seed((seed * 7919 + 17) % 2 ** 63)
    N, Ck, Cv, L = cfg["max_objs"], cfg["keydim"], cfg["valdim"], cfg["num_bases"]
    kappa = torch.randn((count, batch, N, 2, Ck, L), generator=g, device=device)
    kappa = l2norm(kappa * math.sqrt(2.0 / L), -2)
    nu = torch.zeros((batch, N, 2, Cv, L), device=device)
    zita = torch.full((batch, N, 2, 1, L), 1e-6, device=device)
    return [Bases(kappa[i], nu, zita) for i in range(count)]


def program_bases(b):
    """The reference's ``Bases`` as the program's (the same tensors)."""
    from swem_tpu_torch.models.em import Bases

    return Bases(b.kappa, b.nu, b.zita)


def sync(device) -> None:
    import torch

    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


def free_device(device) -> None:
    import gc

    import torch

    gc.collect()
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def per_layer(cell: Cell, summary: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"]).read(summary)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number that the cell's limits name, beside its limit; without
    limits every number, with none (a run that cannot be correct)."""
    if not limits:
        return {k: {"value": v, "limit": None} for k, v in numbers.items()}
    return {k: {"value": numbers.get(k, math.nan), "limit": lim} for k, lim in limits.items()}


def is_correct(compared: Dict[str, dict]) -> bool:
    return bool(compared) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
