"""Small configurations and mixes for the CPU tests: the cells' codes and
rules at sizes a test run holds."""

import json
import pathlib

from perfbench import spec

HERE = pathlib.Path(__file__).resolve().parents[1]


def config(name: str, **changes) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(changes)
    return cfg


def frames(batch=4, pool=2) -> dict:
    return {"entry": "frames", "batch": batch, "pool": pool, "inflight": 2}


def stream(batch=4, push_steps=64, pool=2) -> dict:
    return {"entry": "stream", "batch": batch, "push_steps": push_steps, "pool": pool,
            "inflight": 2}


def cell_spec(cfg: dict, traffic: dict, name: str = "small.cell") -> spec.Spec:
    return spec.Spec(cell={"name": name, "config": cfg["name"], "traffic": traffic["entry"],
                           "chips": 1},
                     config=cfg, traffic=traffic,
                     kernels={"acs_kernel": "acs", "walk_kernel": "chainback"},
                     end_to_end=[{"name": "decoded_mbit_s", "unit": "Mbit/s"},
                                 {"name": "call_gap_p95_ms", "unit": "ms"},
                                 {"name": "setup_s", "unit": "s"}],
                     per_layer=[], chips=1)
