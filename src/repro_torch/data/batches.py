"""Input batches: the dry run's input specs and synthetic data.

``train_specs`` / ``prefill_specs`` say what every (arch x shape) cell
feeds its step: each input leaf as a tensor on the ``meta`` device (shape
and dtype, no storage), the structure ``make_batch`` materializes.
``launch/dryrun.py`` draws its inputs from them. The sharding spec of the
leaves (the reference's ``batch_axes``) waits for the mesh.

The reference draws its tokens with ``jax.random``; the port cannot import
it and draws from ``np.random.default_rng([seed, step, host_index])``. So
its batches differ from the reference's in value, and keep its contract:
deterministic, restartable at any cursor, one shard per host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig, ShapeCell

BF16 = torch.bfloat16


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text positions after reserving frontend (patch) positions."""
    if cfg.frontend == "vision_patches":
        return seq_len - cfg.frontend_tokens
    return seq_len


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _embed_specs(cfg: ModelConfig, B: int, S: int, dtype) -> dict:
    spec = {}
    if cfg.frontend == "vision_patches":
        spec["patch_embeds"] = _spec((B, cfg.frontend_tokens, cfg.d_model), dtype)
    if cfg.is_encoder_decoder:
        spec["enc_embeds"] = _spec((B, S, cfg.d_model), dtype)
    return spec


def train_specs(cfg: ModelConfig, cell: ShapeCell, dtype=BF16) -> dict:
    """The inputs of one train step of ``cell``: tokens and targets (B, S)
    int32, and the frontend or encoder embeddings where the arch has them."""
    B, S = cell.global_batch, cell.seq_len
    st = _text_len(cfg, S)
    return {"tokens": _spec((B, st), torch.int32), "targets": _spec((B, st), torch.int32),
            **_embed_specs(cfg, B, S, dtype)}


def prefill_specs(cfg: ModelConfig, cell: ShapeCell, dtype=BF16) -> dict:
    """The inputs of one prefill of ``cell``: tokens (B, S) int32, and the
    frontend or encoder embeddings where the arch has them."""
    B, S = cell.global_batch, cell.seq_len
    return {"tokens": _spec((B, _text_len(cfg, S)), torch.int32),
            **_embed_specs(cfg, B, S, dtype)}


def make_batch(rng: np.random.Generator, cfg: ModelConfig, *, batch: int, seq: int,
               kind: str = "train", device="cuda") -> dict:
    """Deterministic synthetic batch: tokens (B,S) int32 and, for training,
    the next-token targets (B,S) int32."""
    if cfg.frontend == "vision_patches" or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: frontend and encoder inputs are not ported (ROADMAP queue 1, "
            "enc-dec and VLM)")
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)).to(device)
    out = {"tokens": toks[:, :-1]}
    if kind == "train":
        out["targets"] = toks[:, 1:]
    return out


class TokenStream:
    """Deterministic, restartable, shardable synthetic token pipeline.

    Each host pulls only its shard of the global batch (by host index), and
    the stream position is checkpointable (``state()`` / ``seek()``), which
    the fault-tolerant trainer relies on for exact restart.
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                 host_index: int = 0, host_count: int = 1, device="cuda"):
        if batch % host_count:
            raise ValueError(f"batch {batch} does not split over {host_count} hosts")
        self.cfg = cfg
        self.global_batch = batch
        self.local_batch = batch // host_count
        self.seq = seq
        self.seed = seed
        self.host_index = host_index
        self.device = device
        self.step = 0

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def seek(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"stream seed {state['seed']} on restore, {self.seed} here")
        self.step = int(state["step"])

    def next(self) -> dict:
        rng = np.random.default_rng([self.seed, self.step, self.host_index])
        self.step += 1
        return make_batch(rng, self.cfg, batch=self.local_batch, seq=self.seq,
                          kind="train", device=self.device)
