"""Swin-MoE (``models/swin.py`` of the port) for the train driver.

Each function takes the configuration file as a dict. The port is
imported inside the functions that drive it; the counts and the
reference are the benchmark's own.
"""
from __future__ import annotations

from hexabench import bench, flops, inputs


def port_config(cfg: dict):
    """The port's ``SwinConfig`` of a configuration file."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.swin import SwinConfig

    return bench.port_config(SwinConfig, cfg, moe=MoEConfig(**cfg["moe"]))


def params(cfg: dict, seed: int, device) -> dict:
    return inputs.swin_params(cfg, seed, device)


def make_step(cfg: dict, opt_cfg):
    """The port's train step: ``(params, opt, images, labels) -> (params,
    opt, metrics)``."""
    from repro_torch.models import swin
    from repro_torch.parallel.sharding import ParallelConfig

    tr = cfg["train"]
    return swin.make_train_step(port_config(cfg), ParallelConfig(blk=tr["blk"]),
                                opt_cfg, moe_impl=tr["moe_impl"])


def batch(cfg: dict, mix: dict, gen, device) -> tuple:
    """One step's images and labels."""
    return inputs.image_batch(cfg, mix["batch"], gen, device)


def train_flops(cfg: dict, mix: dict) -> float:
    return flops.swin_train_flops(cfg, mix["batch"])


def expert_bound_s(cfg: dict, mix: dict) -> float:
    return flops.swin_expert_bound_s(cfg, mix["batch"])


def reference_train(cfg: dict, seed: int, batches: list, device,
                    precision: str = "f32") -> dict:
    from hexabench.reference import swin as ref_swin

    return ref_swin.train(cfg, seed, batches, device, precision=precision)
