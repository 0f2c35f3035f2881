"""The model family a configuration file names under `"family"`. Everything
that depends on the U-Net's shape lives in three files of that name, found
by `named.load`, so a U-Net of another shape comes in as new files:

* `portbench/reference/<family>.py`, the plain reference: `unet_spec`,
  `gate_layout`, `route`, `MODULES` (seed tag, constructor, dtype key of
  each reference module, in the order `serve` takes them), `serve`,
  `float32_matmuls`, `to_fp8_`, and `STAGE1`, the name of the family's
  stage-1 reference under `reference/` (None: no training cell);
* `portbench/counts/<family>.py`, the operation counts: `attention_calls`,
  `request_flops`, `stage1_step_flops`;
* `portbench/programs/<family>.py`, the program's frozen models:
  `frozen_models`, `pipeline`.
"""
from __future__ import annotations

from portbench.harness import named


def name(config: dict) -> str:
    if "family" not in config:
        raise ValueError('the configuration names no model family ("family")')
    return config["family"]


def reference(config: dict):
    return named.load("reference", name(config))


def counts(config: dict):
    return named.load("counts", name(config))


def program(config: dict):
    return named.load("programs", name(config))


def stage1(config: dict):
    """The family's stage-1 reference; a family without one has no training
    cell."""
    stage = getattr(reference(config), "STAGE1", None)
    if stage is None:
        raise ValueError(f"the model family {name(config)!r} has no stage-1 reference "
                         f"(STAGE1 in portbench/reference/{name(config)}.py), so no training "
                         "cell can run on it")
    return named.load("reference", stage)
